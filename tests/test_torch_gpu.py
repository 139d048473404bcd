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
    """B1 and B3 of nsf-tpu, realnvp (affine) and a 7-layer nsf (weights
    streamed through shared memory), both modes and the round trip."""
    out = chip_smoke.phase_coupling(cuda, 8192)
    assert sorted(out["flows"]) == ["nsf-7", "nsf-tpu", "realnvp"]
    for name, v in out["flows"].items():
        assert v["ill_conditioned_points"] <= 8192 * 4 * 6 * 1e-4, name


def test_chain_kernel_matches_plain(cuda):
    out = chip_smoke.phase_chain(cuda, 2048, 5)
    assert abs(out["acceptance_kernel"] - out["acceptance_plain"]) < 0.1


@pytest.mark.parametrize("program", chip_smoke.PROGRAMS)
def test_chain_kernel_runs_the_transform_programs(cuda, program):
    """B2 with a bounded data transform, and a periodic or affine
    preconditioning, against the plain chain on injected noise."""
    assert chip_smoke.check_chain_program(cuda, 2048, 5, program) < 2e-3


def test_main_path_routes_through_the_kernels(cuda):
    """The fused anchor through B3 and B2; the split anchor's every density
    pass through B1."""
    out = chip_smoke.phase_main_path(cuda, 8192, 8192)
    assert out["launches"]["coupling"] > 0 and out["launches"]["chain"] > 0
    assert out["split_launches"]["coupling"] >= (
        chip_smoke.CHAIN_STEPS + 2) * out["split_n_mutations"] > 0


def test_maf_kernel_matches_plain(cuda):
    """B4 at n = 8192 and at 8192 + 37, a ragged last 16-particle tile."""
    out = chip_smoke.phase_maf(cuda, 8192)
    assert out["checked_n"] == [8192, 8192 + 37]
    assert out["ill_conditioned_points"] <= 2 * 8229 * 5 * 1e-4


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
    """D4 bit for bit, a draw of no multiple of 4 elements included."""
    out = chip_smoke.phase_prng(cuda, 8192)
    assert out["launches"] > 0 and out["max_abs_err"] == 0.0


def test_chain_philox_bit_exact_after_move(cuda):
    """chain.cu takes Philox4x32-10 from common.cuh: its in-kernel stream
    still equals the injected torch stream bit for bit (phase_chain
    raises otherwise) at the pipeline's tile count."""
    chip_smoke.phase_chain(cuda, 8192, 3)


def test_config5_coupling_kernel_matches_plain(cuda):
    """B1 and B3 at BASELINE config 5's flow shape (d = 32, 6 x (128, 128),
    8 bins: the wide form), both modes and the round trip at n = 16384."""
    c = chip_smoke.coupling_outputs(
        cuda, (chip_smoke.hierarchical_flow(), 12, 0.05), 16384, 1)
    for what, v in c["outputs"].items():
        chip_smoke.assert_kernel_close(*v, f"config 5 {what}")


def test_config5_chain_kernel_matches_plain(cuda):
    """B2 on the hierarchical target at config 5's flow shape: injected
    noise, the Philox replay and independent noise, 2048 x 8 steps."""
    out = chip_smoke.phase_chain(cuda, 2048, 8,
                                 setup=chip_smoke.hierarchical_chain_setup)
    assert abs(out["acceptance_kernel"] - out["acceptance_plain"]) < 0.1


@pytest.mark.parametrize("row", sorted(chip_smoke.VALIDATE_ROWS))
def test_validate_shapes_kernels_match_plain(cuda, row):
    """B1/B3 of nsf-tpu at the validation rows' d = 2 and d = 5 (padded
    halves, the output by dims) against plain under float64 arbitration,
    and B2 on each row's chain (Rosenbrock with its logit program, the
    funnel with its affine one) against the plain chain."""
    from aspire_tpu_torch.flows.architectures import nsf_tpu

    d = chip_smoke.VALIDATE_ROWS[row][1]
    c = chip_smoke.coupling_outputs(cuda, (nsf_tpu(d), 5, 0.1), 8192, 1)
    for what, v in c["outputs"].items():
        chip_smoke.assert_kernel_close(*v, f"{row} {what}")
    setup = chip_smoke.validate_chain_setup(cuda, 2048, 5, row)
    assert chip_smoke.assert_program_chain(setup, row) < 2e-3


@pytest.mark.parametrize("row", sorted(chip_smoke.VALIDATE_ROWS))
def test_validate_rows_route_through_the_kernels(cuda, row):
    """A validation row's anchor at n = 4096 with the fitted flow: every
    mutation one B2 launch, the initial draws on B3."""
    _, asp = chip_smoke.validate_aspire(cuda, row)
    out = chip_smoke.validate_anchor(asp, 4096)
    assert out["config"] == {"rosenbrock": 3, "funnel": 4}[row]
    assert out["launches"]["chain"] == out["n_mutations"] > 0


def test_user_target_evaluation_matches_its_callables(cuda):
    """The regression's instance (its CUDA source built at configuration
    0), its evaluation entry against the user's torch callables."""
    out = chip_smoke.user_target_eval_check(cuda, 8192)
    assert out["log_likelihood_max_err_f64"] < 1e-2


def test_user_target_chain_matches_plain(cuda):
    """B2 built with the regression's source against the plain chain on
    the user's callables at d = 4, and its Philox stream against the
    replay, bit for bit."""
    assert chip_smoke.user_chain_check(cuda, wide=False) < 2e-3


def test_cnf_log_prob_on_the_card_matches_the_cpu(cuda):
    """The CNF's density and sampling passes on the card against the CPU
    (plain torch both; ``chip_smoke.cnf_device_check``'s rule)."""
    out = chip_smoke.cnf_device_check(cuda, 4096, n_hidden=(32, 32),
                                      n_steps=16)
    assert out["log_prob_max_abs_err_f64"] < 1e-3


def test_flow_preconditioned_chain_launches_b3_every_step(cuda):
    """SMC with ``preconditioning="flow"`` (nsf-tpu inside) at n = 4096:
    the split route on the host ladder, at least n_steps + 1 B3 launches
    a rung (the preconditioning's inverse at every chain step)."""
    p, asp = chip_smoke.mixture_aspire(cuda)
    out = chip_smoke.flow_preconditioned_anchor(
        asp, 4096, p.true_log_evidence(), "nsf-tpu")
    assert out["b3"] >= (chip_smoke.CHAIN_STEPS + 1) * out["rungs"] > 0
