"""The gradient samplers' kernels on the card: the gradient through the
coupling and MAF kernels (B1, B4) and the whole-chain kernel's RWMH (B2).

Marked ``gpu``: they skip without a CUDA device and run on the H100 with
``python -m pytest --noconftest tests/test_torch_gradient_gpu.py`` (that
machine has no JAX, which ``tests/conftest.py`` imports). The checks are
``chip_smoke.py``'s (``phase_gradient_samplers`` (a) and (b)), at smaller
sizes.
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


@pytest.mark.parametrize("name", ["nsf-tpu d=2", "nsf-tpu d=4",
                                  "nsf-tpu d=5", "maf-rqs d=4"])
def test_gradient_through_the_kernel_is_the_plain_vjp(cuda, name):
    """``Flow.log_prob``'s value through B1 or B4 meets the card rule; its
    gradient is the plain path's VJP at the kernel's cotangents, bit for
    bit, with one kernel launch."""
    out = chip_smoke.gradient_check(cuda, name, 8192)
    assert out["grad_equals_plain_vjp"]
    assert sum(out["launches"].values()) == 1


def test_chain_kernel_rwmh_matches_plain(cuda):
    """B2 with RWMH (kernel id 2) against the plain chain: injected noise,
    its Philox stream, independent noise."""
    out = chip_smoke.phase_chain(cuda, 2048, 5, chip_smoke.rwmh_chain_setup)
    assert abs(out["acceptance_kernel"] - out["acceptance_plain"]) < 0.1
