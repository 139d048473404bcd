"""The CUDA kernels against their plain torch versions, on the card.

Marked ``gpu``: they skip without a CUDA device (the kernels have no CPU
mode) and run on the H100 with
``python -m pytest --noconftest tests/test_torch_gpu.py`` (that machine has
no JAX, which ``tests/conftest.py`` imports). The
checks and tolerances are ``chip_smoke.py``'s, at smaller sizes.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_coupling_kernel_matches_plain(cuda):
    out = chip_smoke.phase_coupling(cuda, 8192)
    assert out["ill_conditioned_points"] <= 8192 * 4 * 6 * 1e-4


def test_chain_kernel_matches_plain(cuda):
    out = chip_smoke.phase_chain(cuda, 2048, 5)
    assert abs(out["acceptance_kernel"] - out["acceptance_plain"]) < 0.1


def test_main_path_routes_through_the_kernels(cuda):
    out = chip_smoke.phase_main_path(cuda, 8192, 8192)
    assert out["launches"]["coupling"] > 0 and out["launches"]["chain"] > 0


def test_maf_kernel_matches_plain(cuda):
    out = chip_smoke.phase_maf(cuda, 8192)
    assert out["ill_conditioned_points"] <= 8192 * 5 * 1e-4


def test_maf_path_routes_through_the_maf_kernel(cuda):
    out = chip_smoke.phase_maf_main_path(cuda, 8192, 8192)
    assert out["launches"]["maf"] >= (chip_smoke.CHAIN_STEPS + 2) * out[
        "n_mutations"] > 0


def test_staged_coupling_kernels_match_plain(cuda):
    """D1, D2 at every compiled Q, D3 with and without rqs_micro: launched
    on the A/B path, each against its plain schedule and (but D3 micro)
    against B1."""
    out = chip_smoke.phase_staged_coupling(cuda, 8192)
    assert min(out["launches"].values()) > 0
    for key, v in out["variants"].items():
        assert v["ill_conditioned_points"] <= 8192 * 5 * 4 * 1e-4, key


def test_prng_kernel_matches_plain_philox(cuda):
    out = chip_smoke.phase_prng(cuda, 8192)
    assert out["launches"] > 0 and out["max_abs_err"] == 0.0


def test_chain_philox_bit_exact_after_move(cuda):
    """chain.cu takes Philox4x32-10 from common.cuh: its in-kernel stream
    still equals the injected torch stream bit for bit (phase_chain
    raises otherwise) at the pipeline's tile count."""
    chip_smoke.phase_chain(cuda, 8192, 3)
