"""aspire_tpu_torch imports and runs without JAX, h5py or optax."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "aspire_tpu_torch"

_SCRIPT = """
import sys
for name in ("jax", "jaxlib", "h5py", "optax"):
    sys.modules[name] = None
import importlib, pkgutil
import aspire_tpu_torch
for mod in pkgutil.walk_packages(aspire_tpu_torch.__path__, "aspire_tpu_torch."):
    importlib.import_module(mod.name)
import numpy as np, torch
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.models import GaussianProblem
p = GaussianProblem(dims=2)
asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior, dims=2,
             n_hidden=(8, 8), n_layers=2, seed=0, device="cpu")
asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
        n_epochs=2, batch_size=128)
s = asp.sample_posterior(sampler="smc", n_samples=256,
                         sampler_kwargs=dict(n_steps=2))
assert np.isfinite(s.log_evidence)
assert "jax" not in {m.split(".")[0] for m in sys.modules if sys.modules[m]}
print("ok")
"""


def test_port_imports_and_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_port_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import jax|from jax)", re.MULTILINE)
    offenders = [str(p) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
