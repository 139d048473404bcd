#!/usr/bin/env python3
"""Drive aspire_tpu_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):
1. require a CUDA device; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from aspire_tpu_torch/csrc with nvcc;
3. the coupling kernel (density and sampling modes) against the plain
   torch path at nsf-tpu shapes, n = 131072, float32 with TF32 off;
4. the whole-chain kernel against the plain chain at n = 8192, 20 steps:
   injected noise (exact acceptance counts), the in-kernel Philox stream
   against the same stream injected (bit-identical), and Philox against
   independent noise (statistical bounds);
5. the MAF-RQS density kernel against the plain torch path at maf_rqs(4)
   shapes, n = 131072, float32 with TF32 off;
6. the main path: fit an nsf-tpu flow to 4000 draws of the 4-d Gaussian
   mixture, adaptive-tempered SMC at n = 8192 (log Z against the analytic
   value, every mutation on the chain kernel, launch counts), the same
   with the split chain, then the 131072-particle pipeline time;
7. the MAF path: fit a maf-rqs flow to the same draws, SMC at n = 8192
   (log Z against the analytic value, every mutation on the split chain,
   every density pass of it on the MAF kernel: launch counts), the
   default flow_backend ("maf", affine, plain torch) at n = 8192, then
   the maf-rqs 131072-particle pipeline time;
8. the staged coupling kernels (D1-D3), as the dev scripts'
   A/B runs them: their flow (4 coupling layers, (64, 64), 8 bins) at
   n = 131072, each variant through its wrapper and timed in turns with
   the coupling kernel B1 (B1, variant, variant, B1), then held against
   its plain schedule (float64 deciding f32-ill-conditioned points) and,
   but for D3 with rqs_micro, against B1;
9. the uniforms kernel (D4): the probe's (8, 256) at seed (3, 7) and the
   131072 x 8 x 20 uniforms of a 20-step chain, bit for bit against the
   plain Philox stream, beside torch.rand;
10. print kernel and plain times (median of per-call CUDA-event times),
   each kernel's bound, the kernels JSON line and the result line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

N_COUPLING = 131072
N_CHAIN = 8192
N_PIPELINE = 131072
CHAIN_STEPS = 20
# f32 kernel vs f32 plain path: the kernel sums the conditioner in another
# order (sequential FMAs vs cuBLAS) - the JAX package's own kernel bound.
COUPLING_TOL = dict(rtol=1e-3, atol=1e-4)
# The JAX package's fused-chain parity bounds (tests/test_fused_mutation.py).
Z_ATOL, DENSITY_ATOL, STEP_RTOL, STATS_RTOL = 2e-4, 2e-3, 1e-5, 1e-4
# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W): FP32
# outside the tensor cores, TF32 in them, HBM3 bandwidth.
FP32_FLOP_S, TF32_FLOP_S, HBM_BYTE_S = 67e12, 495e12, 3.35e12
PROBE_SEED = (3, 7)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Median over ``reps`` calls of the CUDA-event time of one call
    (after a warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(start.elapsed_time(end) for start, end in events)
    return times[reps // 2]


def perturbed_flow(device, seed: int = 0, arch=None):
    """``arch`` (default nsf-tpu at d = 4) with its identity initialisation
    perturbed by 0.1 N(0, 1) noise on every weight and bias."""
    import torch

    from aspire_tpu_torch.flows.architectures import nsf_tpu

    arch = arch or nsf_tpu(4)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = arch.init(gen, device)
    for net in params["layers"]:
        for layer in net["layers"]:
            for k in ("w", "b"):
                layer[k] = layer[k] + 0.1 * torch.randn(
                    layer[k].shape, generator=gen, device=device)
    return arch, params


def as_float64(params):
    return {"layers": [{"layers": [{k: v.double() for k, v in l.items()}
                                   for l in net["layers"]]}
                       for net in params["layers"]]}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.ops import prng as PR
    from aspire_tpu_torch.ops import staged_coupling as SC

    for counter in (FC.launches, FC.maf_launches, FM.launches,
                    SC.interleaved_launches, SC.q_launches,
                    SC.packed_launches, PR.launches):
        counter.reset()


def coupling_flop(arch) -> int:
    """FLOP per particle of one coupling-flow pass: per layer the
    conditioner's products over the conditioning inputs, both hidden
    layers and the active dims' spline parameters, 2 FLOP per
    multiply-add (the splines' few hundred operations are not counted)."""
    h1, h2 = arch.n_hidden
    flop = 0
    for layer in range(arch.n_layers):
        active = len([i for i in range(arch.dims) if i % 2 == layer % 2])
        flop += 2 * ((arch.dims - active) * h1 + h1 * h2
                     + h2 * active * arch.n_params_per_dim)
    return flop


def maf_flop(arch) -> int:
    """FLOP per particle of the MAF density pass: per layer the MADE's
    products by the weights its masks keep (a masked weight is zero and
    needs no product), 2 FLOP per multiply-add."""
    from aspire_tpu_torch.flows.nets import made_masks

    masks, _ = made_masks(arch.dims, list(arch.n_hidden),
                          arch.n_params_per_dim)
    return arch.n_layers * 2 * int(sum(int(m.sum()) for m in masks))


def bound(flop: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the FP32 compute
    time and the time to move each input and output byte once (and the
    TF32 compute time, for a tensor-core design)."""
    t_op, t_mem = flop / FP32_FLOP_S, nbytes / HBM_BYTE_S
    return {"bound_ms": 1e3 * max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes",
            "bound_tf32_ms": 1e3 * max(flop / TF32_FLOP_S, t_mem),
            "flop": flop, "bytes": nbytes}


def density_bytes(arch, n: int, weight_bytes: int) -> int:
    """x read, z and log_det written, the weights read once."""
    return n * (2 * arch.dims + 1) * 4 + weight_bytes


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def assert_kernel_close(kern, plain, exact, what: str) -> int:
    """Kernel against the plain float32 path at COUPLING_TOL.

    Where the two disagree by more, the point must be ill-conditioned in
    float32: the plain float32 path itself is off the float64 result by a
    comparable amount, the kernel is no farther from float64 than twice
    the plain path (plus the tolerance), and such points are rare (at most
    1e-4 of them). Returns their number.
    """
    tol = COUPLING_TOL["atol"] + COUPLING_TOL["rtol"] * plain.abs()
    bad = (kern - plain).abs() > tol
    n_bad = int(bad.sum())
    if n_bad:
        e_k = (kern.double() - exact).abs()[bad]
        e_p = (plain.double() - exact).abs()[bad]
        if n_bad > 1e-4 * plain.numel() or bool(
                (e_k > 2 * e_p + tol[bad].double()).any()):
            raise AssertionError(
                f"{what}: {n_bad} elements beyond tolerance; kernel error "
                f"vs float64 up to {float(e_k.max()):.3g}, plain float32 "
                f"error {float(e_p.max()):.3g}")
    return n_bad


def phase_coupling(device, n: int) -> dict:
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, params = perturbed_flow(device)
    params64 = as_float64(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    x = 2.0 * torch.randn((n, 4), generator=gen, device=device)
    z_k, ld_k = FC.coupling_kernel_apply(arch, "forward", params, x)
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(params64, x.double())
    n_bad = assert_kernel_close(z_k, z_p, z_e, "density z")
    n_bad += assert_kernel_close(ld_k, ld_p, ld_e, "density log_det")
    x_k, li_k = FC.coupling_kernel_apply(arch, "inverse", params, z_p)
    x_p, li_p = arch.inverse_plain(params, z_p)
    x_e, li_e = arch.inverse_plain(params64, z_p.double())
    n_bad += assert_kernel_close(x_k, x_p, x_e, "sampling x")
    n_bad += assert_kernel_close(li_k, li_p, li_e, "sampling log_det")
    # Round trip through both kernel modes.
    n_bad += assert_kernel_close(x_k, x, x.double(), "round trip x")
    n_bad += assert_kernel_close(li_k, -ld_k, -ld_e, "round trip log_det")
    err = max(max_err(z_k, z_p), max_err(ld_k, ld_p), max_err(x_k, x_p),
              max_err(li_k, li_p))
    out = {"max_abs_err": err, "ill_conditioned_points": n_bad}
    if device.type == "cuda":
        # The kernel alone: the wrapper's per-call weight packing (~60
        # small torch ops) is host time that would hide it.
        w = FC.prepare_params(arch, params)
        out["ms"] = cuda_ms(lambda: FC.launch_packed(arch, "forward", w, x))
        out["plain_ms"] = cuda_ms(lambda: arch.forward_plain(params, x))
        out["inverse_ms"] = cuda_ms(
            lambda: FC.launch_packed(arch, "inverse", w, z_p))
        out["inverse_plain_ms"] = cuda_ms(
            lambda: arch.inverse_plain(params, z_p))
        out["wrapper_ms"] = cuda_ms(
            lambda: FC.coupling_kernel_apply(arch, "forward", params, x))
    log(f"coupling kernel vs plain at n={n}: {out}")
    return out


def phase_maf(device, n: int) -> dict:
    """The MAF-RQS density kernel (B4) against MAF.forward_plain at
    maf_rqs(4) shapes, with a float64 plain run deciding f32-ill-conditioned
    points."""
    import torch

    from aspire_tpu_torch.flows.architectures import maf_rqs
    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, params = perturbed_flow(device, seed=4, arch=maf_rqs(4))
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    x = 2.0 * torch.randn((n, 4), generator=gen, device=device)
    z_k, ld_k = FC.maf_kernel_apply(arch, params, x)
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(as_float64(params), x.double())
    n_bad = assert_kernel_close(z_k, z_p, z_e, "MAF density z")
    n_bad += assert_kernel_close(ld_k, ld_p, ld_e, "MAF density log_det")
    out = {"max_abs_err": max(max_err(z_k, z_p), max_err(ld_k, ld_p)),
           "ill_conditioned_points": n_bad}
    if device.type == "cuda":
        w = FC.prepare_maf_params(arch, params)
        out["ms"] = cuda_ms(lambda: FC.launch_maf(arch, w, x))
        out["plain_ms"] = cuda_ms(lambda: arch.forward_plain(params, x))
        # Through the autograd wrapper the main path calls: weights
        # packed once per parameter set.
        out["wrapper_ms"] = cuda_ms(
            lambda: FC.fused_maf_forward(arch, params, x))
        out["pack_ms"] = cuda_ms(lambda: FC.prepare_maf_params(arch, params))
    log(f"MAF kernel vs plain at n={n}: {out}")
    return out


def phase_staged_coupling(device, n: int) -> dict:
    """D1-D3 as the dev scripts' A/B runs them: their flow and init
    (4 coupling layers, (64, 64), 8 bins, 0.1 N(0, 1) perturbation) on
    n standard-normal inputs; every variant through its wrapper and timed
    in turns with B1 (B1, variant, variant, B1), with the launch counts of
    that run; then each held against its plain schedule and, but for D3
    with rqs_micro, against B1 on the same inputs."""
    import torch

    from aspire_tpu_torch.flows.architectures import Coupling
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import staged_coupling as SC

    arch, params = perturbed_flow(device, seed=6, arch=Coupling(
        dims=4, n_layers=4, n_hidden=(64, 64), transformer="rqs"))
    params64 = as_float64(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    x = torch.randn((n, 4), generator=gen, device=device)
    x64 = x.double()
    w = FC.prepare_params(arch, params)

    def b1():
        return FC.launch_packed(arch, "forward", w, x)

    def variant(apply, launch, plain, exact=None, against_b1=True):
        return dict(apply=apply, launch=launch, plain=plain, exact=exact,
                    against_b1=against_b1)

    # D1 is D2's q = 2 configuration: its run stands for that Q.
    variants = {"D1": variant(
        lambda: SC.interleaved_apply(arch, params, x),
        lambda: SC.launch_interleaved(arch, w, x),
        lambda: SC.staged_plain(arch, params, x, 2, SC.sub_tile(arch, 2)))}
    for q in (q for q in SC.COMPILED_Q if q != 2):
        variants[f"D2 q={q}"] = variant(
            lambda q=q: SC.q_apply(arch, params, x, q),
            lambda q=q: SC.launch_q(arch, w, x, q),
            lambda q=q: SC.staged_plain(arch, params, x, q,
                                        SC.sub_tile(arch, q)))
    s2 = SC.sub_tile(arch, 2)
    variants["D3"] = variant(
        lambda: SC.packed_apply(arch, params, x),
        lambda: SC.launch_packed(arch, w, x),
        lambda: SC.paired_plain(arch, params, x, s2))
    variants["D3 micro"] = variant(
        lambda: SC.packed_apply(arch, params, x, micro=True),
        lambda: SC.launch_packed(arch, w, x, micro=True),
        lambda: SC.paired_plain(arch, params, x, s2, micro=True),
        exact=lambda: SC.paired_plain(arch, params64, x64, s2, micro=True),
        against_b1=False)

    # The A/B path: each variant through its wrapper, then timed in turns
    # with B1, as the dev scripts time `current` before and after.
    reset_launch_counts()
    runs = {}
    for key, v in variants.items():
        out = v["apply"]()
        b1_a = cuda_ms(b1)
        ms_a, ms_b = cuda_ms(v["launch"]), cuda_ms(v["launch"])
        b1_b = cuda_ms(b1)
        runs[key] = {"out": out, "ms": 0.5 * (ms_a + ms_b),
                     "b1_ms": 0.5 * (b1_a + b1_b),
                     "turns_ms": [b1_a, ms_a, ms_b, b1_b]}
        log(f"{key}: B1, variant, variant, B1 = {runs[key]['turns_ms']}")
    launches = {"D1": SC.interleaved_launches.count,
                "D2": SC.q_launches.count, "D3": SC.packed_launches.count}
    log(f"staged A/B path launches: {launches}")
    if device.type == "cuda" and min(launches.values()) < 1:
        raise AssertionError(f"a staged kernel never ran: {launches}")

    # Checks, outside the path's launch counts.
    z_b1, ld_b1 = b1()
    z_e, ld_e = arch.forward_plain(params64, x64)
    results = {}
    for key, v in variants.items():
        z_k, ld_k = runs[key]["out"]
        z_p, ld_p = v["plain"]()
        z_x, ld_x = v["exact"]() if v["exact"] else (z_e, ld_e)
        n_bad = assert_kernel_close(z_k, z_p, z_x, f"{key} z")
        n_bad += assert_kernel_close(ld_k, ld_p, ld_x, f"{key} log_det")
        b1_err = None
        if v["against_b1"]:
            n_bad += assert_kernel_close(z_k, z_b1, z_e, f"{key} z vs B1")
            n_bad += assert_kernel_close(ld_k, ld_b1, ld_e,
                                         f"{key} log_det vs B1")
            b1_err = max(max_err(z_k, z_b1), max_err(ld_k, ld_b1))
        results[key] = {
            "ms": runs[key]["ms"], "b1_ms": runs[key]["b1_ms"],
            "turns_ms": runs[key]["turns_ms"],
            "plain_ms": cuda_ms(v["plain"], reps=5),
            "max_abs_err": max(max_err(z_k, z_p), max_err(ld_k, ld_p)),
            "max_abs_err_vs_b1": b1_err, "ill_conditioned_points": n_bad}
        log(f"{key} vs plain at n={n}: {results[key]}")
    return {"variants": results, "launches": launches,
            **bound(n * coupling_flop(arch),
                    density_bytes(arch, n, FC.weight_bytes(arch)))}


def phase_prng(device, n: int) -> dict:
    """D4: the probe's (8, 256) uniforms at seed (3, 7), and the
    n x 8 x CHAIN_STEPS uniforms of a chain, each bit for bit against the
    plain Philox stream, with torch.rand on a CUDA generator timed beside
    the large draw."""
    import torch

    from aspire_tpu_torch.ops import prng as PR

    shape = (CHAIN_STEPS, 8, n)
    reset_launch_counts()
    probe = PR.prng_uniforms(PROBE_SEED, (8, 256), device)
    draws = PR.prng_uniforms(PROBE_SEED, shape, device)
    ms = cuda_ms(lambda: PR.prng_uniforms(PROBE_SEED, shape, device))
    launches = PR.launches.count
    if device.type == "cuda" and launches < 1:
        raise AssertionError("the uniforms kernel never ran")

    stats = {"mean": float(probe.mean()), "min": float(probe.min()),
             "max": float(probe.max())}
    log(f"probe (8, 256), seed {PROBE_SEED}: {stats}")
    if not (0.0 < stats["min"] and stats["max"] < 1.0):
        raise AssertionError(f"probe uniforms outside (0, 1): {stats}")
    err = 0.0
    for got, want in ((probe, PR.prng_plain(PROBE_SEED, (8, 256), "cpu")),
                      (probe, PR.prng_plain(PROBE_SEED, (8, 256), device)),
                      (draws, PR.prng_plain(PROBE_SEED, shape, device))):
        err = max(err, max_err(got.cpu(), want.cpu()))
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError("uniforms kernel differs from plain Philox")
    # The probe's conversion in float32 maps the largest word to 1.0.
    if not (float(draws.min()) > 0.0 and float(draws.max()) <= 1.0):
        raise AssertionError("uniforms outside (0, 1]")
    m = draws.numel()
    mean, var = float(draws.double().mean()), float(draws.double().var())
    if abs(mean - 0.5) > 5 * math.sqrt(1 / 12 / m) or abs(
            var - 1 / 12) > 5 * math.sqrt((1 / 80 - 1 / 144) / m):
        raise AssertionError(f"uniform moments off: {mean}, {var}")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    out = {"probe": stats, "launches": launches, "ms": ms, "n": m,
           "max_abs_err": err,
           "plain_ms": cuda_ms(lambda: PR.prng_plain(PROBE_SEED, shape,
                                                     device), reps=5),
           "library_ms": cuda_ms(lambda: torch.rand(
               shape, generator=gen, device=device)),
           **bound(0, 4 * m)}
    log(f"uniforms kernel, {m} draws: {out}")
    return out


def chain_setup(device, n: int, steps: int):
    import torch

    from aspire_tpu_torch.models import GaussianMixtureProblem
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.samplers import kernels as K

    arch, params = perturbed_flow(device, seed=2)
    cfg = FM.ChainConfig(arch, "tpcn", steps, nu=5.0, gamma_m=4, gamma_odd=1)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    z0 = torch.randn((n, 4), generator=gen, device=device) * 1.5 + 0.5
    ref = K.fit_gaussian_reference(z0)
    dt = (torch.full((4,), 0.3, device=device),
          torch.full((4,), 1.7, device=device))
    target = GaussianMixtureProblem(4).kernel_target(device)
    step0 = torch.full((n // FM.TILE,), 0.5, device=device)
    refs = (ref.mean, ref.chol, ref.inv_chol)
    return cfg, params, z0, 0.7, step0, refs, target, dt, gen


def phase_chain(device, n: int, steps: int) -> dict:
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, gen = chain_setup(
        device, n, steps)
    noise = torch.rand((steps, cfg.noise_rows, n), generator=gen,
                       device=device).clamp(1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=noise,
                           return_acc_probs=True)
    # Keep every accept uniform a relative 1e-3 away from its acceptance
    # probability (same side, so the plain trajectory is unchanged): f32
    # differences between two correct implementations can then not flip
    # a Metropolis decision.
    acc = plain[-1]
    u = noise[:, -1]
    noise[:, -1] = torch.where(u < acc, torch.minimum(u, acc * (1 - 1e-3)),
                               torch.clamp(torch.maximum(u, acc * (1 + 1e-3)),
                                           max=1.0))
    kern = FM.fused_mh_chain(cfg, params, z0, beta, None, step0, *refs,
                             target, data_transform=dt, noise=noise)
    torch.testing.assert_close(kern[4], plain[4], rtol=0, atol=0)
    torch.testing.assert_close(kern[0], plain[0], rtol=0, atol=Z_ATOL)
    for i in (1, 2, 3):
        torch.testing.assert_close(kern[i], plain[i], rtol=0,
                                   atol=DENSITY_ATOL)
    torch.testing.assert_close(kern[5], plain[5], rtol=STEP_RTOL, atol=0)
    tau_k, mix_k = FM.combine_tile_stats(kern[6], 4)
    tau_p, mix_p = FM.combine_tile_stats(plain[6], 4)
    torch.testing.assert_close(tau_k, tau_p, rtol=STATS_RTOL, atol=0)
    torch.testing.assert_close(mix_k, mix_p, rtol=STATS_RTOL, atol=0)
    err = max(max_err(kern[i], plain[i]) for i in range(4))

    # The in-kernel Philox stream against the same stream injected.
    seed = (0x12345678, 0x9ABCDEF0)
    philox = FM.fused_mh_chain(cfg, params, z0, beta, seed, step0, *refs,
                               target, data_transform=dt)
    injected = torch.stack([
        FM.philox_uniforms(seed, t, cfg.noise_rows, n, device)
        for t in range(steps)])
    replay = FM.fused_mh_chain(cfg, params, z0, beta, None, step0, *refs,
                               target, data_transform=dt, noise=injected)
    for a, b in zip(philox, replay):
        if not torch.equal(a, b):
            raise AssertionError("in-kernel Philox differs from the replay")

    # Philox chain against the plain chain on independent noise.
    other = torch.rand((steps, cfg.noise_rows, n), generator=gen,
                       device=device)
    indep = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, noise=other)
    acc_k = float(philox[4].mean()) / steps
    acc_p = float(indep[4].mean()) / steps
    # Binomial bound on the acceptance rate over n * steps decisions.
    acc_tol = 6 * math.sqrt(2 * 0.25 / (n * steps)) + 0.01
    if abs(acc_k - acc_p) > acc_tol:
        raise AssertionError(f"acceptance {acc_k} vs {acc_p} > {acc_tol}")
    for j in range(4):
        zk, zp = philox[0][:, j], indep[0][:, j]
        var = float(0.5 * (zk.var() + zp.var()))
        d_mean = abs(float(zk.mean() - zp.mean()))
        if d_mean > 6 * math.sqrt(2 * var / n):
            raise AssertionError(f"dim {j}: mean differs by {d_mean}")
        if abs(float(zk.var() - zp.var())) > 6 * var * math.sqrt(4 / n):
            raise AssertionError(f"dim {j}: variance differs")
    out = {"max_abs_err": err, "acceptance_kernel": acc_k,
           "acceptance_plain": acc_p}
    log(f"chain kernel vs plain at n={n}, {steps} steps: {out}")
    return out


def time_chain(device, n: int, steps: int) -> dict:
    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, _ = chain_setup(
        device, n, steps)
    seed = (1, 2)
    return {
        "ms": cuda_ms(lambda: FM.fused_mh_chain(
            cfg, params, z0, beta, seed, step0, *refs, target,
            data_transform=dt), reps=5),
        "plain_ms": cuda_ms(lambda: FM.chain_plain(
            cfg, params, z0, beta, step0, *refs, target,
            data_transform=dt, seed=seed), reps=3),
    }


def phase_main_path(device, n_anchor: int, n_pipeline: int) -> dict:
    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    p = GaussianMixtureProblem(dims=4)
    truth = p.true_log_evidence()
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device)
    reset_launch_counts()
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    samples = asp.sample_posterior(sampler="smc", n_samples=n_anchor,
                                   sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    launches = {"coupling": FC.launches.count, "chain": FM.launches.count,
                "maf": FC.maf_launches.count}
    routes = asp.sampler.history.mutation_route
    log(f"anchor: log Z {samples.log_evidence:.4f} +/- "
        f"{samples.log_evidence_error:.4f} (truth {truth:.4f}), "
        f"{len(routes)} mutations {set(routes)}, launches {launches}")
    if device.type == "cuda" and (launches["coupling"] < 1
                                  or launches["chain"] < 1):
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if set(routes) != {"fused_kernel"}:
        raise AssertionError(f"mutations left the chain kernel: {routes}")
    check_result(samples, n_anchor, truth)

    split = asp.sample_posterior(
        sampler="smc", n_samples=n_anchor,
        sampler_kwargs=dict(n_steps=CHAIN_STEPS, fused_chain=False))
    log(f"split chain: log Z {split.log_evidence:.4f} +/- "
        f"{split.log_evidence_error:.4f}, routes "
        f"{set(asp.sampler.history.mutation_route)}")
    check_result(split, n_anchor, truth)

    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    asp.sample_posterior(**pipeline)
    walls = []
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = asp.sample_posterior(**pipeline)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check_result(big, n_pipeline, truth)
    walls.sort()
    log(f"{n_pipeline}-particle pipeline walls: {walls}")
    return {"launches": launches, "log_z": samples.log_evidence,
            "log_z_err": samples.log_evidence_error, "truth": truth,
            "pipeline_s": walls[1],
            "n_mutations": len(routes)}


def phase_maf_main_path(device, n_anchor: int, n_pipeline: int) -> dict:
    """The MAF path: a maf-rqs flow fitted and run through SMC, where
    every mutation takes the split chain and every density pass of it the
    MAF kernel; then the default flow_backend ("maf", affine) anchor and
    the maf-rqs pipeline."""
    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.flows.architectures import MAF
    from aspire_tpu_torch.models import GaussianMixtureProblem
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    p = GaussianMixtureProblem(dims=4)
    truth = p.true_log_evidence()
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    kw = dict(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
              dims=4, parameters=p.parameters, seed=1, device=device)
    fit_kw = dict(n_epochs=20, batch_size=512, learning_rate=3e-3)
    run_kw = dict(sampler="smc", sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    asp = Aspire(flow_backend="maf-rqs", **kw)
    reset_launch_counts()
    asp.fit(init, **fit_kw)
    samples = asp.sample_posterior(n_samples=n_anchor, **run_kw)
    launches = {"maf": FC.maf_launches.count,
                "coupling": FC.launches.count, "chain": FM.launches.count}
    routes = asp.sampler.history.mutation_route
    log(f"maf-rqs anchor: log Z {samples.log_evidence:.4f} +/- "
        f"{samples.log_evidence_error:.4f} (truth {truth:.4f}), "
        f"{len(routes)} mutations {set(routes)}, launches {launches}")
    if set(routes) != {"split"}:
        raise AssertionError(f"a MAF mutation left the split chain: {routes}")
    # One density pass for the start state, one per step, one after.
    need = (CHAIN_STEPS + 2) * len(routes)
    if device.type == "cuda" and (launches["maf"] < max(need, 1)
                                  or launches["coupling"]
                                  or launches["chain"]):
        raise AssertionError(
            f"the MAF path's density passes left the MAF kernel: "
            f"{launches}, need >= {need} MAF launches")
    check_result(samples, n_anchor, truth)

    default = Aspire(**kw)
    default.fit(init, **fit_kw)
    arch = default.flow.architecture
    if not (isinstance(arch, MAF) and arch.transformer == "affine"):
        raise AssertionError(f"the default flow is not affine MAF: {arch}")
    dpost = default.sample_posterior(n_samples=n_anchor, **run_kw)
    log(f"default (maf) anchor: log Z {dpost.log_evidence:.4f} +/- "
        f"{dpost.log_evidence_error:.4f}, routes "
        f"{set(default.sampler.history.mutation_route)}")
    check_result(dpost, n_anchor, truth)

    asp.sample_posterior(n_samples=n_pipeline, **run_kw)
    walls = []
    for _ in range(3):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        big = asp.sample_posterior(n_samples=n_pipeline, **run_kw)
        if device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check_result(big, n_pipeline, truth)
    walls.sort()
    log(f"maf-rqs {n_pipeline}-particle pipeline walls: {walls}")
    return {"launches": launches, "log_z": samples.log_evidence,
            "log_z_err": samples.log_evidence_error, "truth": truth,
            "default_log_z": dpost.log_evidence,
            "default_log_z_err": dpost.log_evidence_error,
            "pipeline_s": walls[1], "n_mutations": len(routes)}


def check_result(samples, n: int, truth: float) -> None:
    import torch

    if tuple(samples.x.shape) != (n, 4) or not bool(
            torch.isfinite(samples.x).all()):
        raise AssertionError("posterior samples are not finite (n, 4)")
    err = samples.log_evidence_error
    if not math.isfinite(samples.log_evidence) or not math.isfinite(err):
        raise AssertionError("log evidence is not finite")
    tol = max(5 * err, 0.02)
    if abs(samples.log_evidence - truth) >= tol:
        raise AssertionError(
            f"|log Z - truth| = {abs(samples.log_evidence - truth):.4f} "
            f">= {tol:.4f}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: this script runs only on the GPU")
        return 1
    card = card_line()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: the plain path is full float32")
    device = torch.device("cuda")

    from aspire_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"built {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(line.strip())

    coupling = phase_coupling(device, N_COUPLING)
    chain = phase_chain(device, N_CHAIN, CHAIN_STEPS)
    maf = phase_maf(device, N_COUPLING)
    main_path = phase_main_path(device, N_CHAIN, N_PIPELINE)
    maf_path = phase_maf_main_path(device, N_CHAIN, N_PIPELINE)
    chain_t = time_chain(device, N_PIPELINE, CHAIN_STEPS)
    staged = phase_staged_coupling(device, N_COUPLING)
    uniforms = phase_prng(device, N_PIPELINE)

    print(f"[{card}] coupling kernel, density pass, n={N_COUPLING}: "
          f"{coupling['ms']:.4f} ms (plain torch {coupling['plain_ms']:.4f} ms;"
          f" through the wrapper with packing {coupling['wrapper_ms']:.4f} ms)")
    print(f"[{card}] coupling kernel, sampling pass, n={N_COUPLING}: "
          f"{coupling['inverse_ms']:.4f} ms (plain torch "
          f"{coupling['inverse_plain_ms']:.4f} ms)")
    print(f"[{card}] chain kernel, n={N_PIPELINE}, {CHAIN_STEPS} steps: "
          f"{chain_t['ms']:.4f} ms (plain torch {chain_t['plain_ms']:.4f} ms)")
    print(f"[{card}] sample_posterior pipeline, n={N_PIPELINE}: "
          f"{main_path['pipeline_s']:.4f} s (median of 3); anchor log Z "
          f"{main_path['log_z']:.4f} +/- {main_path['log_z_err']:.4f} vs "
          f"{main_path['truth']:.4f}", flush=True)
    print(f"[{card}] MAF kernel, density pass, maf_rqs(4), n={N_COUPLING}: "
          f"{maf['ms']:.4f} ms (plain torch {maf['plain_ms']:.4f} ms; through "
          f"the wrapper, packed once per parameter set, "
          f"{maf['wrapper_ms']:.4f} ms; one packing {maf['pack_ms']:.4f} ms)")
    print(f"[{card}] maf-rqs sample_posterior pipeline, n={N_PIPELINE}: "
          f"{maf_path['pipeline_s']:.4f} s (median of 3); anchor log Z "
          f"{maf_path['log_z']:.4f} +/- {maf_path['log_z_err']:.4f}, default "
          f"maf {maf_path['default_log_z']:.4f} +/- "
          f"{maf_path['default_log_z_err']:.4f} vs {maf_path['truth']:.4f}; "
          f"{maf_path['launches']['maf']} MAF launches in "
          f"{maf_path['n_mutations']} mutations", flush=True)
    from aspire_tpu_torch.flows.architectures import maf_rqs, nsf_tpu
    from aspire_tpu_torch.ops import fused_coupling as FC

    nsf4, maf4 = nsf_tpu(4), maf_rqs(4)
    b1_bound = bound(N_COUPLING * coupling_flop(nsf4),
                     density_bytes(nsf4, N_COUPLING, FC.weight_bytes(nsf4)))
    # B2: one flow density per step and one for the start, z0 read, z and
    # four per-particle outputs written.
    b2_bound = bound(
        (CHAIN_STEPS + 1) * N_PIPELINE * coupling_flop(nsf4),
        N_PIPELINE * (2 * 4 + 4) * 4 + FC.weight_bytes(nsf4))
    b4_bound = bound(
        N_COUPLING * maf_flop(maf4),
        density_bytes(maf4, N_COUPLING,
                      4 * maf4.n_layers * FC.maf_layer_floats(maf4)))
    var = staged["variants"]
    staged_bound = {k: staged[k] for k in
                    ("bound_ms", "bound_by", "bound_tf32_ms", "flop",
                     "bytes")}
    d2 = {"2": var["D1"], **{k[5:]: v for k, v in var.items()
                             if k.startswith("D2")}}
    for key, v in var.items():
        print(f"[{card}] {key}, staged coupling density pass, 4 layers, "
              f"n={N_COUPLING}: {v['ms']:.4f} ms (B1 in turns "
              f"{v['b1_ms']:.4f} ms; plain torch {v['plain_ms']:.4f} ms; "
              f"bound {staged['bound_ms']:.4f} ms FP32)")
    print(f"[{card}] uniforms kernel (D4), {uniforms['n']} draws: "
          f"{uniforms['ms']:.4f} ms (plain torch {uniforms['plain_ms']:.4f} "
          f"ms; torch.rand {uniforms['library_ms']:.4f} ms; bound "
          f"{uniforms['bound_ms']:.4f} ms); probe (8, 256) seed "
          f"{PROBE_SEED}: {uniforms['probe']}", flush=True)
    kernels = [
        {"name": "coupling_kernel (B1 density / B3 sampling)",
         "route": "cuda", "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches": main_path["launches"]["coupling"],
         "max_abs_err": coupling["max_abs_err"],
         "ms": coupling["ms"], "plain_ms": coupling["plain_ms"],
         **b1_bound, "library_ms": None,
         "inverse_ms": coupling["inverse_ms"],
         "inverse_plain_ms": coupling["inverse_plain_ms"]},
        {"name": "chain_kernel (B2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/chain.cu",
         "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
         "launches": main_path["launches"]["chain"],
         "max_abs_err": chain["max_abs_err"],
         "ms": chain_t["ms"], "plain_ms": chain_t["plain_ms"],
         **b2_bound, "library_ms": None},
        {"name": "maf_kernel (B4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/maf.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:598",
         "launches": maf_path["launches"]["maf"],
         "max_abs_err": maf["max_abs_err"],
         "ms": maf["ms"], "plain_ms": maf["plain_ms"],
         **b4_bound, "library_ms": None,
         "wrapper_ms": maf["wrapper_ms"]},
        {"name": "staged_kernel interleaved (D1)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/interleave_ab.py:122",
         "launches": staged["launches"]["D1"],
         "max_abs_err": var["D1"]["max_abs_err"],
         "ms": var["D1"]["ms"], "plain_ms": var["D1"]["plain_ms"],
         **staged_bound, "library_ms": None, "b1_ms": var["D1"]["b1_ms"]},
        {"name": "staged_kernel q (D2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/quad_interleave_ab.py:96",
         "launches": staged["launches"]["D2"],
         "max_abs_err": max(v["max_abs_err"] for v in d2.values()),
         "ms": var["D2 q=4"]["ms"], "plain_ms": var["D2 q=4"]["plain_ms"],
         **staged_bound, "library_ms": None,
         "ms_by_q": {q: v["ms"] for q, v in d2.items()},
         "plain_ms_by_q": {q: v["plain_ms"] for q, v in d2.items()},
         "b1_ms_by_q": {q: v["b1_ms"] for q, v in d2.items()}},
        {"name": "staged_kernel packed (D3)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/packed_ab.py:147",
         "launches": staged["launches"]["D3"],
         "max_abs_err": max(var["D3"]["max_abs_err"],
                            var["D3 micro"]["max_abs_err"]),
         "ms": var["D3"]["ms"], "plain_ms": var["D3"]["plain_ms"],
         **staged_bound, "library_ms": None, "b1_ms": var["D3"]["b1_ms"],
         "micro_ms": var["D3 micro"]["ms"],
         "micro_plain_ms": var["D3 micro"]["plain_ms"]},
        {"name": "prng_uniforms (D4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/prng.cu",
         "replaces": "benchmarks/dev/prng_probe.py:15",
         "launches": uniforms["launches"],
         "max_abs_err": uniforms["max_abs_err"],
         "ms": uniforms["ms"], "plain_ms": uniforms["plain_ms"],
         **{k: uniforms[k] for k in ("bound_ms", "bound_by", "flop",
                                     "bytes")},
         "library_ms": uniforms["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
