"""The coupling kernel's tensor-core layout against the JAX package.

``prepare_mma_params`` packs B1/B3's weights (the layout the whole-chain
kernel shares); ``coupling_packed_plain`` computes the coupling pass from
that buffer the way the kernel reads it. Same inputs (numpy, from a seed)
and converted parameters go through it and through the JAX package's
Pallas coupling kernel in interpret mode, at the JAX package's f32 kernel
bound, for both transformers and a 7-layer flow; in float64 it equals the
plain path. Also: which flows the kernel takes (``should_fuse``,
``coupling_shared_bytes``), the packing kept per parameter set
(``packed_coupling_params``), and two facts behind the card check's
design: the operand split rounds lo, and the 7-layer check flow is
conditioned well enough in float32 for the check to see the kernel.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.ops.fused_coupling import _pallas_apply, prepare_params
from aspire_tpu_torch.flows.architectures import Coupling, nsf, nsf_tpu, realnvp
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)

# (transformer, layers, hidden): nsf-tpu's shape, realnvp's, a 7-layer nsf.
CASES = [("rqs", 3, (64, 64)), ("affine", 4, (64, 64)), ("rqs", 7, (16, 16))]


def _pair(transformer, n_layers, hidden, dtype):
    jarch = JCoupling(dims=4, n_layers=n_layers, n_hidden=hidden,
                      transformer=transformer, num_bins=8, dtype=dtype)
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype), params)
    tarch = Coupling(dims=4, n_layers=n_layers, n_hidden=hidden,
                     transformer=transformer, num_bins=8, dtype=dtype)
    return jarch, params, tarch, flow_params_from_jax(params, dtype=dtype)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("transformer,n_layers,hidden", CASES)
def test_packed_plain_matches_jax_pallas_interpret(transformer, n_layers,
                                                   hidden, mode):
    """The kernel's packed buffer, read as the kernel reads it, against
    the JAX Pallas kernel in interpret mode, float32, rtol 1e-3 / atol
    1e-4 (the JAX package's own kernel tolerance)."""
    jarch, params, tarch, tparams = _pair(transformer, n_layers, hidden,
                                          "float32")
    x = np.random.default_rng(n_layers).normal(size=(256, 4)).astype(
        np.float32)
    yj, ldj = _pallas_apply(jarch, mode, prepare_params(jarch, params),
                            jnp.asarray(x), interpret=True)
    packed = FC.prepare_mma_params(tarch, tparams)
    yt, ldt = FC.coupling_packed_plain(tarch, mode, packed,
                                       torch.as_tensor(x))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(ldt.numpy(), np.asarray(ldj), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["forward", "inverse"])
@pytest.mark.parametrize("transformer,n_layers,hidden", CASES)
def test_packed_plain_float64_equals_plain_path(transformer, n_layers,
                                                hidden, mode):
    """In float64 (weights packed unrounded) the packed pass is the plain
    coupling pass to 1e-10: every weight is where the kernel reads it."""
    _, _, tarch, tparams = _pair(transformer, n_layers, hidden, "float64")
    x = torch.as_tensor(2.0 * np.random.default_rng(5).normal(size=(300, 4)))
    packed = FC.prepare_mma_params(tarch, tparams)
    assert packed.dtype == torch.float64
    assert packed.numel() == n_layers * FC.mma_layout(tarch)[0]
    got = FC.coupling_packed_plain(tarch, mode, packed, x)
    plain = tarch.forward_plain if mode == "forward" else tarch.inverse_plain
    for a, b in zip(got, plain(tparams, x)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-10)


def _cuda_batch(n: int = 8192):
    """What ``should_fuse`` reads of a CUDA float32 batch."""
    return types.SimpleNamespace(is_cuda=True, dim=lambda: 2, shape=(n, 4),
                                 dtype=torch.float32)


def test_should_fuse_takes_every_depth_it_took():
    """The per-particle kernel took a flow whose weights fit one block
    (7 nsf layers, 12 realnvp layers); the streaming kernel needs two
    layers and its warp buffers whatever the depth, so it takes them and
    every deeper one."""
    assert FC.coupling_shared_bytes(nsf_tpu(4)) == 4 * (2 * 7472 + 8 * 1664)
    for arch in (nsf(4, n_layers=7), realnvp(4, n_layers=12)):
        assert FC.coupling_shared_bytes(arch) <= FC.MAX_SHARED_BYTES
        assert FC.should_fuse(arch, _cuda_batch())
    for make in (nsf, realnvp):
        sizes = {FC.coupling_shared_bytes(make(4, n_layers=k))
                 for k in range(1, 41)}
        assert len(sizes) == 1
        assert all(FC.should_fuse(make(4, n_layers=k), _cuda_batch())
                   for k in range(1, 41))
    # What it still refuses: small or CPU batches, and shapes the JAX
    # package's predicate refuses. Any other shape it takes is taken (an
    # instance built for it at first use: tests/test_torch_shapes.py holds
    # the rule case by case).
    assert not FC.should_fuse(nsf_tpu(4), _cuda_batch(FC.MIN_FUSED_N - 1))
    assert not FC.should_fuse(nsf_tpu(4), torch.zeros(8192, 4))
    assert FC.should_fuse(nsf(4, n_hidden=(32, 32)), _cuda_batch())
    assert FC.config_id(nsf(4, n_hidden=(32, 32))) is None
    assert not FC.should_fuse(nsf(4, num_bins=33), _cuda_batch())


def test_packed_coupling_params_packs_once_per_parameter_set():
    """The same leaves at the same versions give the same packed tensor,
    through a rebuilt parameter dict too; an in-place update or a new
    tensor packs anew, equal to ``prepare_mma_params``."""
    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), seed=3)
    first = FC.packed_coupling_params(arch, params)
    assert FC.packed_coupling_params(arch, params) is first
    rebuilt = {"layers": [{"layers": [dict(l) for l in net["layers"]]}
                          for net in params["layers"]]}
    assert FC.packed_coupling_params(arch, rebuilt) is first
    with torch.no_grad():
        params["layers"][1]["layers"][2]["w"].mul_(1.5)
    second = FC.packed_coupling_params(arch, params)
    assert second is not first
    torch.testing.assert_close(second, FC.prepare_mma_params(arch, params),
                               rtol=0, atol=0)
    params["layers"][0]["layers"][0]["b"] = (
        params["layers"][0]["layers"][0]["b"] + 1.0)
    third = FC.packed_coupling_params(arch, params)
    assert third is not second
    torch.testing.assert_close(third, FC.prepare_mma_params(arch, params),
                               rtol=0, atol=0)


def test_chain_kernel_shares_the_layout():
    """The chain kernel's layout names are the shared tensor-core
    layout's: one packing serves B1/B3 and B2."""
    assert FM.chain_layout is FC.mma_layout
    assert FM.chain_sections is FC.mma_sections
    assert FM.chain_group is FC.mma_group
    assert FM.prepare_chain_params is FC.prepare_mma_params
    assert FM.chain_conditioner_plain is FC.mma_conditioner_plain
    assert FC.mma_group(realnvp(4)) == 8 and FC.mma_group(nsf_tpu(4)) == 24


def _cut_to_float32(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32 rounded toward zero."""
    y = x.float()
    return torch.where(y.double().abs() > x.abs(),
                       torch.nextafter(y, torch.zeros_like(y)), y)


def _split_mlp(round_lo: bool, sums: str = "exact"):
    """A coupling conditioner whose two wide products are taken the way
    ``split_tf32`` and the tensor core take them: each weight the sum of
    two TF32 values split exactly, each activation hi (rounded to TF32)
    plus lo, lo rounded to TF32 (``round_lo``) or cut to it (the tensor
    core's own reading of a float32 operand), the three products
    lo.hi + hi.lo + hi.hi exact. ``sums``: "exact" rounds their whole sum
    once to float32; the others model ``mma.sync``, which returns its
    8-wide k-step's exact sum plus the accumulator cut to float32: "in
    place" sums every product into the running accumulator, "k-step" sums
    a k-step's three from zero and adds them to it in float32
    (``mma_split_step``)."""
    def cut(t):
        return (t.view(torch.int32) & -0x2000).view(torch.float32)

    def product(a, w):
        w = FC.split_tf32_sum(w)
        wh, hi = cut(w), FC._round_tf32(a)
        lo = (FC._round_tf32 if round_lo else cut)(a - hi)
        wl, hi, lo, wh = (t.double() for t in (w - wh, hi, lo, wh))
        if sums == "exact":
            return (lo @ wh + hi @ wl + hi @ wh).float()
        d = torch.zeros(a.shape[0], w.shape[1])
        for k in (slice(s, s + 8) for s in range(0, a.shape[1], 8)):
            s = d if sums == "in place" else torch.zeros_like(d)
            for u, v in ((lo, wh), (hi, wl), (hi, wh)):
                s = _cut_to_float32(s.double() + u[:, k] @ v[k])
            d = s if sums == "in place" else d + s
        return d

    def mlp(params, x):
        l1, l2, l3 = params["layers"]
        h = torch.relu(x @ l1["w"] + l1["b"])
        h = torch.relu(product(h, l2["w"]) + l2["b"])
        return product(h, l3["w"]) + l3["b"]
    return mlp


def test_rounded_lo_split_keeps_the_card_tolerance(monkeypatch):
    """Why ``split_tf32`` rounds lo: cut to TF32, as the tensor core reads
    a float32 operand, its error has one sign in every term of a product;
    on chip_smoke's perturbed nsf-tpu-shaped flow and a 131072-point draw
    the density pass then misses the card rule (COUPLING_TOL with float64
    arbitration), and with lo rounded it holds."""
    import aspire_tpu_torch.flows.architectures as arch_module

    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), seed=0,
                                             arch=nsf(4, n_layers=3))
    x = 2.0 * torch.randn((131072, 4),
                          generator=torch.Generator().manual_seed(3))
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())

    def check(round_lo):
        monkeypatch.setattr(arch_module, "apply_mlp", _split_mlp(round_lo))
        z, ld = arch.forward_plain(params, x)
        chip_smoke.assert_kernel_close(z, z_p, z_e, "emulated z")
        chip_smoke.assert_kernel_close(ld, ld_p, ld_e, "emulated log_det")

    check(round_lo=True)
    with pytest.raises(AssertionError, match="beyond tolerance"):
        check(round_lo=False)


def test_kstep_sums_keep_the_card_tolerance(monkeypatch):
    """Why the tensor-core kernels sum each k-step's split products from
    zero (``mma_split_step``): the tensor core cuts the sum it returns to
    float32, an error of one sign. Summed into the running accumulator,
    every product costs it such a cut; on chip_smoke's nsf-tpu check flow
    and an 8192-point draw the density pass then misses the card rule;
    its log-det error against float64 is over twice plain float32's (root
    mean square), and its mean (the one-sided part) over half plain's mean
    absolute error. Summed from zero and added in float32, the pass holds
    the rule, its error's root mean square within a quarter of plain's and
    its mean under a tenth of plain's mean absolute error."""
    import aspire_tpu_torch.flows.architectures as arch_module

    arch, params = chip_smoke.perturbed_flow(torch.device("cpu"), seed=0)
    x = 2.0 * torch.randn((8192, 4),
                          generator=torch.Generator().manual_seed(1))
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(chip_smoke.as_float64(params), x.double())
    err_p = ld_p.double() - ld_e

    def check(sums):
        monkeypatch.setattr(arch_module, "apply_mlp",
                            _split_mlp(round_lo=True, sums=sums))
        z, ld = arch.forward_plain(params, x)
        err = ld.double() - ld_e
        ratio = (float(err.square().mean() / err_p.square().mean()) ** 0.5,
                 abs(float(err.mean())) / float(err_p.abs().mean()))
        chip_smoke.assert_kernel_close(z, z_p, z_e, "emulated z")
        chip_smoke.assert_kernel_close(ld, ld_p, ld_e, "emulated log_det")
        return ratio

    rms, mean = check("k-step")
    assert rms < 1.25 and mean < 0.1
    with pytest.raises(AssertionError, match="beyond tolerance"):
        check("in place")
    monkeypatch.setattr(chip_smoke, "assert_kernel_close",
                        lambda *args: 0)
    rms, mean = check("in place")
    assert rms > 2 and mean > 0.5


def test_card_rule_fails_a_kernel_output_that_is_not_a_number():
    """``chip_smoke.assert_kernel_close`` holds a kernel output that is
    NaN (a buffer read before its copy landed, say) as beyond the
    tolerance, wherever it lies: ``(kern - plain).abs() > tol`` alone is
    false at NaN."""
    gen = torch.Generator().manual_seed(0)
    exact = torch.randn(20000, generator=gen, dtype=torch.float64)
    plain = exact.float()
    assert chip_smoke.assert_kernel_close(plain.clone(), plain, exact,
                                          "same") == 0
    kern = plain.clone()
    kern[7] = float("nan")
    with pytest.raises(AssertionError, match="beyond tolerance"):
        chip_smoke.assert_kernel_close(kern, plain, exact, "nan")


def test_ptxas_report_reads_registers_and_spills_per_kernel():
    """``chip_smoke.ptxas_report`` (``--wide-ab``) takes each wide
    kernel's registers, stack and spill bytes from an ``-Xptxas -v`` log
    and leaves the other kernels out."""
    log = """ptxas info    : Compiling entry function '_Z20coupling_kernel_wideILb1EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z20coupling_kernel_wideILb1EEvv
    96 bytes stack frame, 8 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 96 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z14coupling_kernelv' for 'sm_90a'
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers
ptxas info    : Compiling entry function '_Z17chain_kernel_widev' for 'sm_90a'
ptxas info    : Used 200 registers
"""
    assert chip_smoke.ptxas_report(log) == {
        "_Z20coupling_kernel_wideILb1EEvv": {
            "stack": 96, "spill_stores": 8, "spill_loads": 20,
            "registers": 255},
        "_Z17chain_kernel_widev": {"registers": 200}}


@pytest.mark.parametrize("shared", [(), ("accuracy", "ptxas")])
def test_path_ab_averages_each_case_over_its_two_turns(monkeypatch, shared):
    """``chip_smoke.path_ab`` (every ``--*-ab`` mode) runs this file's turn
    function in both checkouts in turns (parent, change, change, parent)
    and gives, per checkout, each case's times averaged over its two
    turns and the entries ``shared`` of its first turn."""
    def turn(checkout, t):
        return {"checkout": checkout,
                "times": {"B2": {"ms": t, "ms_single_call": t + 1,
                                 "kernel_ms": t + 2}},
                **{key: f"{checkout} {t}" for key in shared}}

    seen = {}

    def fake_turns(parent, code, what):
        seen.update(parent=parent, code=code, what=what)
        return [turn("parent", 1.0), turn("change", 2.0),
                turn("change", 4.0), turn("parent", 3.0)]

    monkeypatch.setattr(chip_smoke, "ab_turns", fake_turns)
    out = chip_smoke.path_ab("../parent", "chain_turn", "", "chain", shared)
    assert (seen["parent"], seen["what"]) == ("../parent", "chain")
    assert "cs.chain_turn()" in seen["code"]
    assert out["parent"]["B2"] == {"ms": 2.0, "ms_single_call": 3.0,
                                   "kernel_ms": 4.0}
    assert out["change"]["B2"] == {"ms": 3.0, "ms_single_call": 4.0,
                                   "kernel_ms": 5.0}
    assert [t["checkout"] for t in out["turns"]] == [
        "parent", "change", "change", "parent"]
    for key in shared:
        assert out["parent"][key] == "parent 1.0"
        assert out["change"][key] == "change 2.0"


def test_seven_layer_check_flow_is_float32_conditioned(monkeypatch):
    """Why ``chip_smoke.coupling_flows`` perturbs the 7-layer flow by
    0.05: perturbed by 0.1, as the shallower flows are, its plain float32
    sampling pass, the card check's reference, is itself farther from
    float64 than COUPLING_TOL (over twice, on this draw), and a pass more
    accurate than plain (its two wide products rounded once from their
    exact split-TF32 sum) misses the card rule there, so the check would
    measure float32's conditioning rather than the kernel. By 0.05 the
    plain pass stays within half the tolerance and that pass holds the
    rule."""
    import aspire_tpu_torch.flows.architectures as arch_module

    arch, seed, scale = chip_smoke.coupling_flows()["nsf-7"]
    assert arch.n_layers == 7 and scale == 0.05
    x = 2.0 * torch.randn((131072, 4),
                          generator=torch.Generator().manual_seed(2))
    plain_mlp = arch_module.apply_mlp

    def sampling(scale):
        """The plain float32 sampling pass's largest error against float64
        in units of the tolerance, and whether the exactly summed pass
        holds the card rule."""
        arch_, params = chip_smoke.perturbed_flow(torch.device("cpu"), seed,
                                                  arch, scale)
        monkeypatch.setattr(arch_module, "apply_mlp", plain_mlp)
        z, _ = arch_.forward_plain(params, x)
        got, _ = arch_.inverse_plain(params, z)
        want, _ = arch_.inverse_plain(chip_smoke.as_float64(params),
                                      z.double())
        tol = (chip_smoke.COUPLING_TOL["atol"]
               + chip_smoke.COUPLING_TOL["rtol"] * want.abs())
        monkeypatch.setattr(arch_module, "apply_mlp",
                            _split_mlp(round_lo=True))
        exact, _ = arch_.inverse_plain(params, z)
        holds = chip_smoke.rule_holds(*chip_smoke.rule_points(exact, got,
                                                              want),
                                      got.numel())
        return float(((got.double() - want).abs() / tol).max()), holds

    big, holds = sampling(0.1)
    assert big > 2 and not holds
    small, holds = sampling(scale)
    assert small < 0.5 and holds
