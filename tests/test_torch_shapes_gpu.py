"""Instances built at first use, on the card: one of each source.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
mode) and run on the H100 with
``python -m pytest --noconftest tests/test_torch_shapes_gpu.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports). Each builds an
instance of ``csrc/coupling.cu``, ``chain.cu`` or ``maf.cu`` for a shape
outside the prebuilt library (``ops/_build.py::load_instance``) through the
wrapper the main path calls, and holds it against its plain version with
``chip_smoke.py``'s checks and tolerances, at smaller sizes.
"""

import pytest
import torch

import chip_smoke
from aspire_tpu_torch.flows.architectures import maf_rqs, nsf_tpu
from aspire_tpu_torch.ops import _build
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_coupling_instance_matches_plain(cuda):
    """B1 and B3 of nsf-tpu at d = 15 (the wide form, odd d) through the
    wrapper, on the shape's instance, both modes and the round trip."""
    arch = nsf_tpu(15)
    assert FC.config_id(arch) is None
    c = chip_smoke.coupling_outputs(
        cuda, (arch, 21, chip_smoke.SHAPES_SCALE), 8192, 1)
    for what, v in c["outputs"].items():
        chip_smoke.assert_kernel_close(*v, f"d=15 {what}")
    assert _build.instance_path("coupling", FC.coupling_row(arch)).exists()


def test_chain_instance_matches_plain(cuda):
    """B2 at d = 15 (the wide form) on the mixture, injected noise, on the
    shape's instance."""
    setup = chip_smoke.shapes_chain_setup(cuda, 2048, 5)
    assert chip_smoke.assert_program_chain((*setup, None), "d=15") < 2e-3
    arch = setup[0].arch
    assert FM.chain_library(setup[0], 1)[1] == 0
    assert _build.instance_path("chain", FM.chain_row(arch)).exists()


def test_maf_instance_matches_plain(cuda):
    """B4 of maf-rqs at d = 15 (4 layers: the streamed form) on the shape's
    instance, at n = 8192 and a ragged 8192 + 37."""
    arch, params = chip_smoke.perturbed_flow(cuda, 22, maf_rqs(15),
                                             chip_smoke.SHAPES_SCALE)
    assert FC.maf_form(arch) == "streamed"
    params64 = chip_smoke.as_float64(params)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(23)
    for n in (8192, 8192 + 37):
        x = 2.0 * torch.randn((n, 15), generator=gen, device=cuda)
        z_k, ld_k = FC.maf_kernel_apply(arch, params, x)
        z_p, ld_p = arch.forward_plain(params, x)
        z_e, ld_e = arch.forward_plain(params64, x.double())
        chip_smoke.assert_kernel_close(z_k, z_p, z_e, f"z n={n}")
        chip_smoke.assert_kernel_close(ld_k, ld_p, ld_e, f"log_det n={n}")
    assert _build.instance_path("maf_streamed", FC.maf_row(arch)).exists()
