"""aspire_tpu_torch imports and runs without JAX, h5py, matplotlib, pandas
or optax: its SMC checkpoints and resumes in memory, and each file, plot or
frame path raises ``ImportError`` naming the missing package."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "aspire_tpu_torch"

_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "h5py", "optax", "matplotlib", "pandas"):
    sys.modules[name] = None
import importlib, pkgutil
import aspire_tpu_torch
for mod in pkgutil.walk_packages(aspire_tpu_torch.__path__, "aspire_tpu_torch."):
    importlib.import_module(mod.name)
import numpy as np, torch
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianProblem
from aspire_tpu_torch.samplers.base import Sampler
p = GaussianProblem(dims=2)
asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior, dims=2,
             n_hidden=(8, 8), n_layers=2, seed=0, device="cpu")
asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
        n_epochs=2, batch_size=128)
run = dict(sampler="smc", n_samples=256, sampler_kwargs=dict(n_steps=2))
states = []
s = asp.sample_posterior(**run, checkpoint_callback=states.append)
assert np.isfinite(s.log_evidence) and states
mid = Sampler.serialize_checkpoint_state(states[0])
r = asp.sample_posterior(**run, resume_from=mid)
assert np.isfinite(r.log_evidence) and asp.sampler.history.beta[-1] == 1.0
for fn, package in (
        (lambda: asp.sample_posterior(**run, checkpoint_path="x.h5"), "h5py"),
        (lambda: asp.sampler.sample(256, checkpoint_every=1,
                                    checkpoint_file_path="x.h5"), "h5py"),
        (lambda: Aspire.resume_from_file("x.h5", log_likelihood=None,
                                         log_prior=None), "h5py"),
        (lambda: s.plot_corner(), "matplotlib"),
        (lambda: asp.sampler.history.plot(), "matplotlib"),
        (lambda: s.to_dataframe(), "pandas")):
    try:
        fn()
    except ImportError as err:
        assert repr(package) in str(err), err
    else:
        raise AssertionError(f"no ImportError naming {package}")
loaded = {m.split(".")[0] for m in sys.modules if sys.modules[m]}
assert not loaded & {"jax", "h5py", "matplotlib", "pandas"}, loaded
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    """No port source and not ``chip_smoke.py`` imports JAX or anything of
    the JAX package ``aspire_tpu`` (``aspire_tpu_torch`` is the port)."""
    patterns = [
        re.compile(r"^\s*(import jax|from jax)", re.MULTILINE),
        re.compile(r"^\s*(import|from)\s+aspire_tpu(?![\w])", re.MULTILINE),
    ]
    sources = [*PACKAGE.rglob("*.py"), ROOT / "chip_smoke.py"]
    offenders = [(str(p), pattern.pattern) for p in sources
                 for pattern in patterns if pattern.search(p.read_text())]
    assert offenders == []
    # The patterns see what they must, and not the port's own name.
    assert patterns[1].search("from aspire_tpu.ops import fused_coupling")
    assert patterns[1].search("import aspire_tpu")
    assert patterns[1].search("from aspire_tpu import Aspire")
    assert not patterns[1].search("from aspire_tpu_torch import Aspire")
    assert not patterns[1].search("import aspire_tpu_torch.ops")


_USER_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "h5py", "optax", "matplotlib", "pandas"):
    sys.modules[name] = None
import numpy as np, torch
torch.set_num_threads(1)
import chip_smoke
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_mutation as FM
p = chip_smoke.PolynomialRegression()
asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior, dims=4,
             flow_backend="nsf", architecture="nsf-tpu", n_hidden=(8, 8),
             n_layers=2, seed=0, device="cpu")
asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
        n_epochs=2, batch_size=128)
s = asp.sample_posterior(sampler="smc", n_samples=256,
                         sampler_kwargs=dict(n_steps=2))
assert np.isfinite(s.log_evidence)
assert set(asp.sampler.history.mutation_route) == {"fused_kernel"}
assert isinstance(asp.sampler._kernel_target()[0], FM.UserTarget)
assert _build.user_library_path(p.kernel_target()[0], 0).name.startswith(
    "libaspire_user_polynomial_regression_")
mods = {m.split(".")[0] for m in sys.modules if sys.modules[m]}
assert "jax" not in mods and "aspire_tpu" not in mods, mods
print("ok")
"""


def test_user_target_path_imports_nothing_of_jax():
    """With a user's own target loaded (``chip_smoke.PolynomialRegression``
    through ``KernelSource``, its SMC on the whole-chain route on the CPU),
    neither JAX nor anything of ``aspire_tpu`` is imported."""
    out = subprocess.run([sys.executable, "-c", _USER_SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
