"""The flow kernels at hidden depths other than two, and the kill switch,
on the card.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
mode) and run on the H100 with
``python -m pytest --noconftest tests/test_torch_depths_gpu.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports).

- B1/B3, B2 and B4 at one, three and no hidden layers, each on the shape's
  instance built at first use, through the wrappers the main path calls,
  against their plain versions with ``chip_smoke.py``'s checks and
  tolerances, at small sizes.
- The JAX package's switch: under ``ASPIRE_TPU_FUSED=0`` the flow passes
  and the split chain run plain, with no kernel launch counted; with
  ``fused_chain=True`` the chain kernel runs all the same.
"""

import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import Coupling, maf_rqs, nsf_tpu
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module", autouse=True)
def instances():
    """Every instance the module runs, built at once (one nvcc each)."""
    if not torch.cuda.is_available():
        return
    from concurrent.futures import ThreadPoolExecutor

    from aspire_tpu_torch.ops import _build

    rows = {("coupling", FC.coupling_row(a)) for a in COUPLINGS.values()}
    rows |= {("chain" if FC.mma_wide(a) or FM.chain_resident(a)
              else "chain_streamed", FM.chain_row(a)) for a in CHAINS}
    rows |= {("maf" if FC.maf_form(a) == "resident" else "maf_streamed",
              FC.maf_row(a)) for a in MAFS}
    with ThreadPoolExecutor(len(rows)) as pool:
        list(pool.map(lambda r: _build.build_instance(*r), rows))


COUPLINGS = {
    "(128,) d=4": nsf_tpu(4, n_hidden=(128,)),
    "(64, 64, 64) d=4": nsf_tpu(4, n_hidden=(64, 64, 64)),
    "(16,) d=15 wide": nsf_tpu(15, n_hidden=(16,)),
    "(64, 64, 64) d=15 wide": nsf_tpu(15, n_hidden=(64, 64, 64)),
    "() d=5": nsf_tpu(5, n_hidden=()),
    "affine (32, 32, 32, 32) d=7": Coupling(
        dims=7, n_layers=4, n_hidden=(32, 32, 32, 32), transformer="affine"),
}


@pytest.mark.parametrize("name", COUPLINGS)
def test_depth_coupling_instance_matches_plain(cuda, name):
    """B1 and B3 at another depth through the wrapper, both modes and the
    round trip, on the shape's instance."""
    arch = COUPLINGS[name]
    assert FC.config_id(arch) is None and FC.coupling_takes(arch)
    FC.launches.reset()
    c = chip_smoke.coupling_outputs(
        cuda, (arch, 21, chip_smoke.SHAPES_SCALE), 8192, 1)
    for what, v in c["outputs"].items():
        chip_smoke.assert_kernel_close(*v, f"{name} {what}")
    assert FC.launches.count >= 2


CHAINS = [nsf_tpu(4, n_hidden=(128,)), nsf_tpu(4, n_hidden=(64, 64, 64)),
          nsf_tpu(10, n_hidden=(64,), n_layers=4), nsf_tpu(4, n_hidden=()),
          nsf_tpu(15, n_hidden=(64, 64, 64))]
MAFS = [maf_rqs(4, n_hidden=(128,)), maf_rqs(4, n_hidden=(64, 64, 64)),
        maf_rqs(15, n_hidden=(64, 64, 64)), maf_rqs(5, n_hidden=())]


@pytest.mark.parametrize("arch", CHAINS, ids=lambda a: f"{a.n_hidden}")
def test_depth_chain_instance_matches_plain(cuda, arch):
    """B2 at another depth in its form (resident, streamed or wide) on the
    mixture, injected noise, on the shape's instance."""
    setup = chip_smoke.shapes_chain_setup(cuda, 2048, 5, arch)
    assert chip_smoke.assert_program_chain((*setup, None), "depth") < 2e-3
    assert FM.chain_library(setup[0], 1)[1] == 0


@pytest.mark.parametrize("arch", MAFS,
                         ids=lambda a: f"{a.dims}-{a.n_hidden}")
def test_depth_maf_instance_matches_plain(cuda, arch):
    """B4 at another depth (resident, or streamed at d = 15) on the
    shape's instance, at n = 8192 and a ragged 8192 + 37."""
    arch, params = chip_smoke.perturbed_flow(cuda, 22, arch,
                                             chip_smoke.SHAPES_SCALE)
    params64 = chip_smoke.as_float64(params)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    for n in (8192, 8192 + 37):
        x = 2.0 * torch.randn((n, arch.dims), generator=gen, device=cuda)
        z_k, ld_k = FC.maf_kernel_apply(arch, params, x)
        z_p, ld_p = arch.forward_plain(params, x)
        z_e, ld_e = arch.forward_plain(params64, x.double())
        chip_smoke.assert_kernel_close(z_k, z_p, z_e, f"z n={n}")
        chip_smoke.assert_kernel_close(ld_k, ld_p, ld_e, f"log_det n={n}")


def test_the_switch_turns_the_kernels_off(cuda, monkeypatch):
    """Under ``ASPIRE_TPU_FUSED=0`` a coupling flow's passes, a MAF's
    density and an SMC run's mutations (the split chain) on the card count
    no kernel launch; with ``fused_chain=True`` the chain kernel runs."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    monkeypatch.setenv("ASPIRE_TPU_FUSED", "0")
    arch, params = chip_smoke.perturbed_flow(cuda, 3)
    maf = maf_rqs(4)
    maf_params = maf.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    x = torch.randn((8192, 4), device=cuda)
    chip_smoke.reset_launch_counts()
    z, _ = arch.forward(params, x)
    arch.inverse(params, z)
    maf.forward(maf_params, x)
    p = GaussianMixtureProblem(dims=4)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=cuda)
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 2000)),
            n_epochs=2, batch_size=512)
    asp.sample_posterior(sampler="smc", n_samples=4096,
                         sampler_kwargs=dict(n_steps=4))
    assert set(asp.sampler.history.mutation_route) == {"split"}
    counts = chip_smoke.launch_counts()
    assert not any(counts.values()), counts
    asp.sample_posterior(sampler="smc", n_samples=4096,
                         sampler_kwargs=dict(n_steps=4, fused_chain=True))
    assert set(asp.sampler.history.mutation_route) == {"fused_kernel"}
    assert chip_smoke.launch_counts()["chain"] >= 1
