#!/usr/bin/env python3
"""Drive aspire_tpu_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero), the two
main paths (6, 7) right after the build:
1. require a CUDA device; print its name and power limit (nvidia-smi);
2. build the CUDA kernels from aspire_tpu_torch/csrc with nvcc;
3. the coupling kernel (density and sampling modes, and the round trip)
   against the plain torch path at n = 131072, float32 with TF32 off, for
   nsf-tpu, realnvp (the affine configuration) and a 7-layer nsf (the
   deepest spline flow the kernel took before it streamed its weights);
4. the whole-chain kernel (B2) against the plain chain at n = 8192, 20 steps:
   injected noise (exact acceptance counts), the in-kernel Philox stream
   against the same stream injected (bit-identical), and Philox against
   independent noise (statistical bounds);
5. the MAF-RQS density kernel against the plain torch path at maf_rqs(4)
   shapes, n = 131072, 8192 and 8192 + 37 (a ragged last tile), float32
   with TF32 off;
6. the main path: fit an nsf-tpu flow to 4000 draws of the 4-d Gaussian
   mixture, adaptive-tempered SMC at n = 8192 (log Z against the analytic
   value, every mutation on the chain kernel, launch counts), the same
   with the split chain (at least n_steps + 2 coupling-kernel launches per
   mutation, counted over that run alone), then the 131072-particle
   pipeline time;
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
9. the uniforms kernel (D4): the probe's (8, 256) at seed (3, 7), the
   131072 x 8 x 20 uniforms of a 20-step chain and a draw whose size is
   no multiple of 4, bit for bit against the plain Philox stream; timed in
   turns with torch.rand (D4, torch.rand, torch.rand, D4);
10. print kernel and plain times, each kernel's bound, the kernels JSON
   line and the result line. A time is device time: one CUDA-event pair
   around 20 back-to-back calls after a warm-up (cuda_ms); the earlier
   yardstick, an event pair around each single call (cuda_ms_single), is
   kept beside it as ms_single_call, and the kernel alone, as the
   profiler's CUDA activity records it (kernel_ms), with it. Every
   kernel_ms reading is made after every event time and pipeline: once
   the profiler has traced the card, each launch costs the host more.
   A bound is the least time on the pipes the kernel computes with (the
   FP32 pipe; for B1/B3, B2 and B4 their split-TF32 tensor-core products
   beside it).

``python3 chip_smoke.py --chain-ab PARENT`` runs none of that: it times
the chain kernel B2 of the checkout at PARENT (e.g. a ``git archive`` of
the parent commit) and of this checkout in turns, each turn a process of
its own (``chain_ab``). ``--coupling-ab PARENT`` does the same for the
coupling kernel's two modes, B1 and B3, on the flows of phase 3, and
reads phase 3's check of both checkouts' kernels on 20 input draws per
flow (``coupling_ab``).
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
    """Device time of one call: one CUDA-event pair around ``reps``
    back-to-back calls (after a warm-up call), divided by ``reps``. The
    host enqueues the next call while the device runs the last, so the
    host's per-call work is hidden wherever it is shorter than the call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuda_ms_single(fn, reps: int = 20) -> float:
    """The earlier yardstick, kept to compare methods: median over
    ``reps`` calls of an event pair around each ONE call (after a warm-up
    call). Where the device waits for the host, the start event fires
    before the call is enqueued, so the host's work counts as the
    call's."""
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


def kernel_ms(fn, match: str, reps: int = 20) -> float:
    """Device time of one call's kernels whose name contains ``match``:
    their durations as the profiler's CUDA activity (CUPTI) records them,
    over ``reps`` calls after a warm-up, per call. The kernel alone: where
    a wrapper's host work per call is as long as its kernel, cuda_ms
    measures the host instead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if match in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler recorded no kernel {match!r}")
    return us / reps / 1e3


# kernel_ms readings the phases note, made by read_kernel_ms at the end of
# the run: once torch.profiler has traced the card (CUPTI), every later
# launch costs the host more, so no event time and no pipeline may follow.
_KERNEL_MS_LATER: list = []


def kernel_ms_later(out: dict, key: str, fn, match: str,
                    reps: int = 20) -> None:
    """Note a kernel_ms reading of ``fn`` for ``out[key]``."""
    _KERNEL_MS_LATER.append((out, key, fn, match, reps))


def read_kernel_ms() -> None:
    """Make every noted kernel_ms reading, in the order noted."""
    for out, key, fn, match, reps in _KERNEL_MS_LATER:
        out[key] = kernel_ms(fn, match, reps)
    _KERNEL_MS_LATER.clear()


def perturbed_flow(device, seed: int = 0, arch=None, scale: float = 0.1):
    """``arch`` (default nsf-tpu at d = 4) with its identity initialisation
    perturbed by ``scale`` N(0, 1) noise on every weight and bias."""
    import torch

    from aspire_tpu_torch.flows.architectures import nsf_tpu

    arch = arch or nsf_tpu(4)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = arch.init(gen, device)
    for net in params["layers"]:
        for layer in net["layers"]:
            for k in ("w", "b"):
                layer[k] = layer[k] + scale * torch.randn(
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


def coupling_flop_parts(arch) -> tuple[int, int]:
    """FLOP per particle of one coupling-flow pass, 2 per multiply-add, as
    (first layer, the two wide layers): per layer the conditioner's
    products over the conditioning inputs, then both hidden layers and the
    active dims' spline parameters (the splines' few hundred operations
    are not counted). The chain kernel runs the first part on the FP32
    pipe and the second on the tensor cores."""
    h1, h2 = arch.n_hidden
    first = wide = 0
    for layer in range(arch.n_layers):
        active = len([i for i in range(arch.dims) if i % 2 == layer % 2])
        first += 2 * (arch.dims - active) * h1
        wide += 2 * (h1 * h2 + h2 * active * arch.n_params_per_dim)
    return first, wide


def coupling_flop(arch) -> int:
    """FLOP per particle of one coupling-flow pass (both parts)."""
    return sum(coupling_flop_parts(arch))


def maf_flop(arch) -> tuple[int, int]:
    """FLOP per particle of the MAF density pass: per layer the MADE's
    products by the weights its masks keep (a masked weight is zero and
    needs no product), 2 FLOP per multiply-add; as (first layer, the
    two wide layers), the part the MAF kernel runs on the FP32 pipe and
    the part it runs on the tensor cores."""
    from aspire_tpu_torch.flows.nets import made_masks

    masks, _ = made_masks(arch.dims, list(arch.n_hidden),
                          arch.n_params_per_dim)
    kept = [arch.n_layers * 2 * int(m.sum()) for m in masks]
    return kept[0], kept[1] + kept[2]


def bound(flop: float, nbytes: float, tensor_flop: float = 0.0) -> dict:
    """The least time the card could take for the work, on the pipes the
    kernel computes it with: the larger of the time of ``flop`` on the
    FP32 pipe, of ``tensor_flop`` on the tensor cores in TF32 at three
    products each (the split form that keeps float32 accuracy), and of
    moving each input and output byte once. Beside it, all of the work on
    the FP32 pipe and all of it in one TF32 pass."""
    t_op = max(flop / FP32_FLOP_S, 3 * tensor_flop / TF32_FLOP_S)
    t_mem, total = nbytes / HBM_BYTE_S, flop + tensor_flop
    return {"bound_ms": 1e3 * max(t_op, t_mem),
            "bound_by": "operations" if t_op >= t_mem else "bytes",
            "bound_fp32_ms": 1e3 * max(total / FP32_FLOP_S, t_mem),
            "bound_tf32_ms": 1e3 * max(total / TF32_FLOP_S, t_mem),
            "flop": total, "tensor_flop": tensor_flop, "bytes": nbytes}


def density_bytes(arch, n: int, weight_bytes: int) -> int:
    """x read, z and log_det written, the weights read once."""
    return n * (2 * arch.dims + 1) * 4 + weight_bytes


def max_err(a, b) -> float:
    return float((a - b).abs().max())


def rule_points(kern, plain, exact):
    """The card rule's reading of a kernel output: at the points where
    the kernel and the plain float32 path differ by more than
    COUPLING_TOL, the kernel's and the plain path's errors against the
    float64 result ``exact``, and the tolerance there."""
    tol = COUPLING_TOL["atol"] + COUPLING_TOL["rtol"] * plain.abs()
    bad = (kern - plain).abs() > tol
    return ((kern.double() - exact).abs()[bad],
            (plain.double() - exact).abs()[bad], tol[bad].double())


def rule_holds(e_k, e_p, tol, numel: int) -> bool:
    """The card rule on ``rule_points``: a point where kernel and plain
    disagree must be ill-conditioned in float32 (the plain path itself off
    the float64 result by a comparable amount: the kernel no farther from
    it than twice the plain path plus the tolerance), and such points rare
    (at most 1e-4 of ``numel``)."""
    return e_k.numel() <= 1e-4 * numel and not bool(
        (e_k > 2 * e_p + tol).any())


def assert_kernel_close(kern, plain, exact, what: str) -> int:
    """Kernel against the plain float32 path at COUPLING_TOL, float64
    deciding the points where they disagree (``rule_holds``). Returns the
    number of such points."""
    e_k, e_p, tol = rule_points(kern, plain, exact)
    if not rule_holds(e_k, e_p, tol, plain.numel()):
        raise AssertionError(
            f"{what}: {e_k.numel()} elements beyond tolerance; kernel error "
            f"vs float64 up to {float(e_k.max()):.3g}, plain float32 "
            f"error {float(e_p.max()):.3g}")
    return e_k.numel()


def coupling_flows() -> dict:
    """The coupling flows the coupling kernel is held to, each with the
    seed and scale of its perturbed weights: nsf-tpu (the main path's),
    realnvp (the affine configuration) and a 7-layer nsf (the deepest
    spline flow the per-particle kernel took, whose layers the kernel
    streams). The 7-layer flow's weights are perturbed by half as much:
    perturbed by 0.1 its plain float32 sampling pass, the check's
    reference, is itself beyond COUPLING_TOL of float64 at more points
    than the check lets kernel and plain disagree (1e-4 of them), so any
    other float32 pass would miss the check there, whatever its
    rounding (``test_seven_layer_check_flow_is_float32_conditioned``;
    ``coupling_accuracy`` reads both scales on the card)."""
    from aspire_tpu_torch.flows.architectures import nsf, nsf_tpu, realnvp

    return {"nsf-tpu": (nsf_tpu(4), 0, 0.1), "realnvp": (realnvp(4), 8, 0.1),
            "nsf-7": (nsf(4, n_layers=7), 9, 0.05)}


def coupling_outputs(device, flow: tuple, n: int, draw: int) -> dict:
    """B1 and B3 of ``flow`` (an entry of ``coupling_flows``) through the
    wrapper, each output beside the plain float32 path's and the float64
    one: the density pass on n inputs (input draw ``draw``), the sampling
    pass on the plain path's latents, and the round trip through both
    kernel modes. Returns them with the flow's inputs and parameters."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, seed, scale = flow
    arch, params = perturbed_flow(device, seed, arch, scale)
    params64 = as_float64(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw)
    x = 2.0 * torch.randn((n, 4), generator=gen, device=device)
    if device.type == "cuda" and not FC.should_fuse(arch, x):
        raise AssertionError("the coupling kernel refuses the flow")
    z_k, ld_k = FC.coupling_kernel_apply(arch, "forward", params, x)
    z_p, ld_p = arch.forward_plain(params, x)
    z_e, ld_e = arch.forward_plain(params64, x.double())
    x_k, li_k = FC.coupling_kernel_apply(arch, "inverse", params, z_p)
    x_p, li_p = arch.inverse_plain(params, z_p)
    x_e, li_e = arch.inverse_plain(params64, z_p.double())
    return {"arch": arch, "params": params, "x": x, "z": z_p, "outputs": {
        "density z": (z_k, z_p, z_e), "density log_det": (ld_k, ld_p, ld_e),
        "sampling x": (x_k, x_p, x_e), "sampling log_det": (li_k, li_p, li_e),
        "round trip x": (x_k, x, x.double()),
        "round trip log_det": (li_k, -ld_k, -ld_e)}}


def check_coupling_flow(device, name: str, n: int) -> dict:
    """``coupling_outputs`` of the flow ``name`` on input draw 1, every
    output held to the card rule (``assert_kernel_close``). Returns the
    flow's inputs, parameters and errors."""
    c = coupling_outputs(device, coupling_flows()[name], n, 1)
    n_bad = sum(assert_kernel_close(*v, f"{name} {what}")
                for what, v in c["outputs"].items())
    err = max(max_err(k, p) for what, (k, p, _) in c["outputs"].items()
              if not what.startswith("round trip"))
    log(f"{name} coupling kernel vs plain at n={n}: max abs {err:.3g}, "
        f"{n_bad} ill-conditioned points")
    return {**{k: c[k] for k in ("arch", "params", "x", "z")},
            "max_abs_err": err, "ill_conditioned_points": n_bad}


def check_coupling(device, n: int) -> dict:
    """``check_coupling_flow`` of every flow of ``coupling_flows``."""
    return {name: check_coupling_flow(device, name, n)
            for name in coupling_flows()}


def coupling_accuracy(device, n: int, draws: int) -> dict:
    """The card rule on input draws 1..``draws`` of every flow of
    ``coupling_flows``, and of the 7-layer flow perturbed by 0.1, read
    rather than asserted. Per flow: the draws it misses; at the points it
    flags, the quantiles of the kernel's error against float64 over the
    plain float32 path's, and the largest share of its limit
    (2 x plain + tolerance) the kernel's error takes; the points where
    the plain path itself is beyond COUPLING_TOL of float64, which no
    kernel changes; and per output over every point of every draw, the
    root mean square and the mean of the kernel's and the plain path's
    errors against float64 (a one-sided rounding shows as a mean far from
    0)."""
    import torch

    from aspire_tpu_torch.flows.architectures import nsf

    flows = {**coupling_flows(), "nsf-7 at 0.1": (nsf(4, n_layers=7), 9, 0.1)}
    out = {}
    for name, flow in flows.items():
        missed, ratios, margin, plain_beyond, sums = [], [], 0.0, 0, {}
        for draw in range(1, draws + 1):
            ok = True
            for what, (k, p, e) in coupling_outputs(
                    device, flow, n, draw)["outputs"].items():
                e_k, e_p, tol = rule_points(k, p, e)
                ok = ok and rule_holds(e_k, e_p, tol, p.numel())
                ratios.append(e_k / e_p.clamp_min(1e-30))
                if e_k.numel():
                    margin = max(margin, float((e_k / (2 * e_p + tol)).max()))
                if what.startswith("round trip"):
                    continue
                d_k, d_p = k.double() - e, p.double() - e
                plain_beyond += int((d_p.abs() > COUPLING_TOL["atol"]
                                     + COUPLING_TOL["rtol"] * e.abs()).sum())
                acc = sums.setdefault(what, torch.zeros(5, dtype=torch.float64,
                                                        device=device))
                acc += torch.stack([d_k.square().sum(), d_p.square().sum(),
                                    d_k.sum(), d_p.sum(),
                                    torch.tensor(float(e.numel()),
                                                 device=device)])
            if not ok:
                missed.append(draw)
        r = torch.cat(ratios)
        q = ([float(v) for v in torch.quantile(
            r, torch.tensor([0.5, 0.9, 1.0], dtype=r.dtype, device=device))]
            if r.numel() else [])
        errors = {}
        for what, (ssk, ssp, sk, sp, m) in ((w, a.tolist())
                                            for w, a in sums.items()):
            errors[what] = {"rms_kernel": math.sqrt(ssk / m),
                            "rms_plain": math.sqrt(ssp / m),
                            "mean_kernel": sk / m, "mean_plain": sp / m}
        out[name] = {"draws": draws, "missed": missed,
                     "flagged_points": int(r.numel()),
                     "ratio_q50_q90_max": q, "worst_share_of_limit": margin,
                     "plain_beyond_tol": plain_beyond, "errors": errors}
    return out


def phase_coupling(device, n: int) -> dict:
    """``check_coupling`` at n, then each flow's kernel timed in both modes
    on weights packed once: events, single calls and alone, beside the
    plain path; nsf-tpu's through the wrapper too."""
    from aspire_tpu_torch.ops import fused_coupling as FC

    flows = {}
    for name, c in check_coupling(device, n).items():
        arch, params, x, z = c["arch"], c["params"], c["x"], c["z"]
        out = {"n_layers": arch.n_layers, "transformer": arch.transformer,
               "max_abs_err": c["max_abs_err"],
               "ill_conditioned_points": c["ill_conditioned_points"]}
        flows[name] = out
        if device.type != "cuda":
            continue
        w = FC.prepare_mma_params(arch, params)
        for mode, key, inp, plain in (
                ("forward", "", x, arch.forward_plain),
                ("inverse", "inverse_", z, arch.inverse_plain)):
            def run(arch=arch, mode=mode, w=w, inp=inp):
                return FC.launch_packed(arch, mode, w, inp)

            out[key + "ms"] = cuda_ms(run)
            out[key + "ms_single_call"] = cuda_ms_single(run)
            kernel_ms_later(out, key + "kernel_ms", run, "coupling_kernel")
            out[key + "plain_ms"] = cuda_ms(
                lambda plain=plain, inp=inp: plain(params, inp))
        if name == "nsf-tpu":
            # Through the wrapper the main path calls: weights packed once
            # per parameter set.
            out["wrapper_ms"] = cuda_ms(
                lambda: FC.coupling_kernel_apply(arch, "forward", params, x))
            out["pack_ms"] = cuda_ms(
                lambda: FC.prepare_mma_params(arch, params))
        log(f"{name} coupling kernel at n={n}: {out}")
    return {**flows["nsf-tpu"], "flows": flows,
            "max_abs_err": max(v["max_abs_err"] for v in flows.values()),
            "ill_conditioned_points": sum(v["ill_conditioned_points"]
                                          for v in flows.values())}


def phase_maf(device, n: int, n_small: int = N_CHAIN) -> dict:
    """The MAF-RQS density kernel (B4) against MAF.forward_plain at
    maf_rqs(4) shapes, with a float64 plain run deciding f32-ill-conditioned
    points: at n, at n_small (the anchors' size) and at n_small + 37 (a
    ragged last tile); the kernel timed at n and n_small."""
    import torch

    from aspire_tpu_torch.flows.architectures import maf_rqs
    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, params = perturbed_flow(device, seed=4, arch=maf_rqs(4))
    params64 = as_float64(params)
    w = FC.prepare_maf_params(arch, params)
    gen = torch.Generator(device=device)
    gen.manual_seed(5)
    out = {"max_abs_err": 0.0, "ill_conditioned_points": 0, "checked_n": []}
    for m in dict.fromkeys((n, n_small, n_small + 37)):
        x = 2.0 * torch.randn((m, 4), generator=gen, device=device)
        z_k, ld_k = FC.maf_kernel_apply(arch, params, x)
        z_p, ld_p = arch.forward_plain(params, x)
        z_e, ld_e = arch.forward_plain(params64, x.double())
        out["ill_conditioned_points"] += assert_kernel_close(
            z_k, z_p, z_e, f"MAF density z, n={m}")
        out["ill_conditioned_points"] += assert_kernel_close(
            ld_k, ld_p, ld_e, f"MAF density log_det, n={m}")
        out["max_abs_err"] = max(out["max_abs_err"], max_err(z_k, z_p),
                                 max_err(ld_k, ld_p))
        out["checked_n"].append(m)
        if device.type != "cuda" or m == n_small + 37:
            continue
        key = "" if m == n else f"_n{m}"
        out["ms" + key] = cuda_ms(lambda: FC.launch_maf(arch, w, x))
        out["ms_single_call" + key] = cuda_ms_single(
            lambda: FC.launch_maf(arch, w, x))
        kernel_ms_later(out, "kernel_ms" + key,
                        lambda x=x: FC.launch_maf(arch, w, x), "maf_kernel")
        if m == n:
            out["plain_ms"] = cuda_ms(lambda: arch.forward_plain(params, x))
            # Through the autograd wrapper the main path calls: weights
            # packed once per parameter set.
            out["wrapper_ms"] = cuda_ms(
                lambda: FC.fused_maf_forward(arch, params, x))
    if device.type == "cuda":
        out["pack_ms"] = cuda_ms(lambda: FC.prepare_maf_params(arch, params))
    log(f"MAF kernel vs plain at n={out['checked_n']}: {out}")
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
    # The staged kernels' per-particle layout, and B1's own.
    w = FC.prepare_params(arch, params)
    w_b1 = FC.prepare_mma_params(arch, params)

    def b1():
        return FC.launch_packed(arch, "forward", w_b1, x)

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
                     "turns_ms": [b1_a, ms_a, ms_b, b1_b],
                     "ms_single_call": cuda_ms_single(v["launch"])}
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
            "ms_single_call": runs[key]["ms_single_call"],
            "plain_ms": cuda_ms(v["plain"]),
            "max_abs_err": max(max_err(z_k, z_p), max_err(ld_k, ld_p)),
            "max_abs_err_vs_b1": b1_err, "ill_conditioned_points": n_bad}
        kernel_ms_later(results[key], "kernel_ms", v["launch"],
                        "staged_kernel")
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
    # A draw whose size is no multiple of 4 (a ragged last Philox block).
    ragged = (3, N_CHAIN + 37)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    def d4():
        return PR.prng_uniforms(PROBE_SEED, shape, device)

    def rand():
        return torch.rand(shape, generator=gen, device=device)

    reset_launch_counts()
    probe = PR.prng_uniforms(PROBE_SEED, (8, 256), device)
    draws = d4()
    odd = PR.prng_uniforms(PROBE_SEED, ragged, device)
    # In turns (D4, torch.rand, torch.rand, D4), as phase_staged_coupling
    # times each variant against B1.
    turns = [cuda_ms(d4), cuda_ms(rand), cuda_ms(rand), cuda_ms(d4)]
    log(f"D4, torch.rand, torch.rand, D4 = {turns}")
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
                      (draws, PR.prng_plain(PROBE_SEED, shape, device)),
                      (odd, PR.prng_plain(PROBE_SEED, ragged, device))):
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
    out = {"probe": stats, "launches": launches, "n": m, "max_abs_err": err,
           "ms": 0.5 * (turns[0] + turns[3]),
           "library_ms": 0.5 * (turns[1] + turns[2]), "turns_ms": turns,
           "plain_ms": cuda_ms(lambda: PR.prng_plain(PROBE_SEED, shape,
                                                     device)),
           **bound(0, 4 * m)}
    if device.type == "cuda":
        out["ms_single_call"] = cuda_ms_single(d4)
        out["library_ms_single_call"] = cuda_ms_single(rand)
        kernel_ms_later(out, "kernel_ms", d4, "prng_kernel")
        kernel_ms_later(out, "library_kernel_ms", rand, "distribution")
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


def nudge_accept_uniforms(noise, acc) -> None:
    """Keep every accept uniform (the last row of ``noise``) a relative
    1e-3 away from its acceptance probability ``acc`` (the plain chain's
    per-step ones), on the same side, so the plain trajectory is unchanged:
    f32 differences between two correct implementations can then not flip
    a Metropolis decision. In place."""
    import torch

    u = noise[:, -1]
    noise[:, -1] = torch.where(u < acc, torch.minimum(u, acc * (1 - 1e-3)),
                               torch.clamp(torch.maximum(u, acc * (1 + 1e-3)),
                                           max=1.0))


def assert_chain_close(kern, plain) -> float:
    """A chain's outputs against the plain chain's on the same nudged
    noise: acceptance counts exact, z, the densities, the step sizes and
    the combined statistics at the JAX package's parity bounds. Returns
    the largest difference of z and the densities."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

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
    return max(max_err(kern[i], plain[i]) for i in range(4))


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
    nudge_accept_uniforms(noise, plain[-1])
    kern = FM.fused_mh_chain(cfg, params, z0, beta, None, step0, *refs,
                             target, data_transform=dt, noise=noise)
    err = assert_chain_close(kern, plain)

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
    def kernel():
        return FM.fused_mh_chain(cfg, params, z0, beta, seed, step0, *refs,
                                 target, data_transform=dt)

    out = {
        "ms": cuda_ms(kernel),
        "ms_single_call": cuda_ms_single(kernel),
        "plain_ms": cuda_ms(lambda: FM.chain_plain(
            cfg, params, z0, beta, step0, *refs, target,
            data_transform=dt, seed=seed)),
    }
    kernel_ms_later(out, "kernel_ms", kernel, "chain_kernel", reps=5)
    return out


# One turn of chain_ab, run by a process of its own from the root of the
# checkout timed: that checkout's B2 through its own wrapper, on
# time_chain's inputs, by events and then alone.
CHAIN_AB_TURN = """
import json, torch
import chip_smoke as cs
from aspire_tpu_torch.ops import fused_mutation as FM
cfg, params, z0, beta, step0, refs, target, dt, _ = cs.chain_setup(
    torch.device("cuda"), {n}, {steps})
def chain():
    return FM.fused_mh_chain(cfg, params, z0, beta, (1, 2), step0, *refs,
                             target, data_transform=dt)
out = {{"ms": cs.cuda_ms(chain), "ms_single_call": cs.cuda_ms_single(chain)}}
out["kernel_ms"] = cs.kernel_ms(chain, "chain_kernel", reps=5)
print(json.dumps(out))
"""


def ab_turns(parent: str, code: str, what: str) -> list:
    """``python -c code`` in the checkout at ``parent`` and in this one, in
    turns (parent, change, change, parent), each a process of its own
    that prints one JSON object last; the objects, each with its
    checkout's name."""
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
    turns = []
    for name, root in (("parent", parent), ("change", here),
                       ("change", here), ("parent", parent)):
        done = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=600)
        if done.returncode:
            raise RuntimeError(f"{name} turn failed:\n{done.stderr[-4000:]}")
        turns.append({"checkout": name,
                      **json.loads(done.stdout.splitlines()[-1])})
        log(f"{what} A/B turn: {turns[-1]}")
    return turns


def chain_ab(parent: str) -> dict:
    """B2 of the checkout at ``parent`` against this one's, at
    n = N_PIPELINE and CHAIN_STEPS steps, in turns (parent, change, change,
    parent) on the same card; each turn a process of its own, which builds
    its checkout's kernels (a first call, not timed) and reads the kernel
    alone after its events."""
    turns = ab_turns(parent, CHAIN_AB_TURN.format(n=N_PIPELINE,
                                                  steps=CHAIN_STEPS), "chain")
    return {"turns": turns, **{
        name: {key: sum(t[key] for t in turns if t["checkout"] == name) / 2
               for key in ("ms", "ms_single_call", "kernel_ms")}
        for name in ("parent", "change")}}


def coupling_turn(n: int, draws: int) -> dict:
    """One turn of ``coupling_ab``, in the checkout whose
    ``aspire_tpu_torch`` the process imports: B1 and B3 of every flow of
    ``coupling_flows`` on input draw 1, packed once in that checkout's
    layout and launched through its ``launch_packed``, by events and then
    alone; and ``coupling_accuracy`` of its wrapper on ``draws`` draws."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pack = getattr(FC, "prepare_mma_params", None) or FC.prepare_params
    times, later = {}, []
    for name, (arch, seed, scale) in coupling_flows().items():
        arch, params = perturbed_flow(dev, seed, arch, scale)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = 2.0 * torch.randn((n, 4), generator=gen, device=dev)
        w = pack(arch, params)
        for mode in ("forward", "inverse"):
            def run(arch=arch, mode=mode, w=w, x=x):
                return FC.launch_packed(arch, mode, w, x)

            key = f"{name} {mode}"
            times[key] = {"ms": cuda_ms(run),
                          "ms_single_call": cuda_ms_single(run)}
            later.append((key, run))
    accuracy = coupling_accuracy(dev, n, draws)
    for key, run in later:
        times[key]["kernel_ms"] = kernel_ms(run, "coupling_kernel")
    return {"times": times, "accuracy": accuracy}


# One turn of coupling_ab, run by a process of its own from the root of
# the checkout measured: this file, loaded by path, measures the kernel of
# that checkout.
COUPLING_AB_TURN = """
import importlib.util, json
spec = importlib.util.spec_from_file_location("chip_smoke_turn", {here!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(json.dumps(cs.coupling_turn({n}, {draws})))
"""


def coupling_ab(parent: str, draws: int = 20) -> dict:
    """B1 (density) and B3 (sampling) of the checkout at ``parent``
    against this one's, for every flow of ``coupling_flows`` at
    n = N_COUPLING, in turns (parent, change, change, parent) on the same
    card, each turn a process of its own as in ``chain_ab``: their times,
    and the card rule read on ``draws`` input draws per flow (the same in
    both turns of a checkout: the kernels are deterministic)."""
    from pathlib import Path

    turns = ab_turns(parent, COUPLING_AB_TURN.format(
        here=str(Path(__file__).resolve()), n=N_COUPLING, draws=draws),
        "coupling")
    cases = list(turns[0]["times"])
    return {"turns": [{"checkout": t["checkout"], **t["times"]}
                      for t in turns], **{
        name: {**{case: {key: sum(t["times"][case][key] for t in turns
                                  if t["checkout"] == name) / 2
                         for key in ("ms", "ms_single_call", "kernel_ms")}
                  for case in cases},
               "accuracy": next(t["accuracy"] for t in turns
                                if t["checkout"] == name)}
        for name in ("parent", "change")}}


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

    # The split chain: every density pass through Flow.log_prob, so on B1.
    reset_launch_counts()
    split = asp.sample_posterior(
        sampler="smc", n_samples=n_anchor,
        sampler_kwargs=dict(n_steps=CHAIN_STEPS, fused_chain=False))
    split_launches = {"coupling": FC.launches.count,
                      "chain": FM.launches.count,
                      "maf": FC.maf_launches.count}
    split_routes = asp.sampler.history.mutation_route
    log(f"split chain: log Z {split.log_evidence:.4f} +/- "
        f"{split.log_evidence_error:.4f}, {len(split_routes)} mutations "
        f"{set(split_routes)}, launches {split_launches}")
    if set(split_routes) != {"split"}:
        raise AssertionError(f"a mutation left the split chain: {split_routes}")
    # One density pass for the start state, one per step, one after.
    need = (CHAIN_STEPS + 2) * len(split_routes)
    if device.type == "cuda" and (split_launches["coupling"] < max(need, 1)
                                  or split_launches["chain"]):
        raise AssertionError(
            f"the split chain's density passes left the coupling kernel: "
            f"{split_launches}, need >= {need} coupling launches")
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
            "pipeline_s": walls[1], "pipeline_walls_s": walls,
            "n_mutations": len(routes), "split_launches": split_launches,
            "split_n_mutations": len(split_routes),
            "split_log_z": split.log_evidence,
            "split_log_z_err": split.log_evidence_error}


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
            "pipeline_s": walls[1], "pipeline_walls_s": walls,
            "n_mutations": len(routes)}


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


def coupling_bound(arch, n: int) -> dict:
    """B1/B3's bound at n: the conditioner's first layer on the FP32 pipe,
    its two wide layers on the tensor cores in split TF32 (as B2's); x
    read, z and log_det written, the packed weights read once."""
    from aspire_tpu_torch.ops import fused_coupling as FC

    first, wide = coupling_flop_parts(arch)
    return bound(n * first, density_bytes(
        arch, n, 4 * arch.n_layers * FC.mma_layout(arch)[0]),
        tensor_flop=n * wide)


def coupling_entry(coupling: dict, name: str) -> dict:
    """The kernels line's numbers of one flow of ``phase_coupling``, with
    its bound at N_COUPLING."""
    arch = coupling_flows()[name][0]
    v = coupling["flows"][name]
    return {"n_layers": arch.n_layers, "transformer": arch.transformer,
            "max_abs_err": v["max_abs_err"],
            **{k: v[k] for k in (
                "ms", "ms_single_call", "kernel_ms", "plain_ms",
                "inverse_ms", "inverse_ms_single_call", "inverse_kernel_ms",
                "inverse_plain_ms")},
            **coupling_bound(arch, N_COUPLING)}


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

    main_path = phase_main_path(device, N_CHAIN, N_PIPELINE)
    maf_path = phase_maf_main_path(device, N_CHAIN, N_PIPELINE)
    coupling = phase_coupling(device, N_COUPLING)
    chain = phase_chain(device, N_CHAIN, CHAIN_STEPS)
    maf = phase_maf(device, N_COUPLING)
    chain_t = time_chain(device, N_PIPELINE, CHAIN_STEPS)
    staged = phase_staged_coupling(device, N_COUPLING)
    uniforms = phase_prng(device, N_PIPELINE)
    # The profiler last: after it has traced the card, every launch costs
    # the host more, and the pipelines and short kernels' events show it.
    read_kernel_ms()

    for name, (arch, *_) in coupling_flows().items():
        v = coupling["flows"][name]
        b = coupling_bound(arch, N_COUPLING)
        print(f"[{card}] coupling kernel, {name} ({arch.n_layers} layers, "
              f"{arch.transformer}), n={N_COUPLING}: density {v['ms']:.4f} "
              f"ms events, {v['kernel_ms']:.4f} ms alone (plain torch "
              f"{v['plain_ms']:.4f} ms); sampling {v['inverse_ms']:.4f} ms "
              f"events, {v['inverse_kernel_ms']:.4f} ms alone (plain torch "
              f"{v['inverse_plain_ms']:.4f} ms); bound {b['bound_ms']:.4f} "
              f"ms, split TF32")
    print(f"[{card}] nsf-tpu coupling kernel through the wrapper, packed once "
          f"per parameter set: {coupling['wrapper_ms']:.4f} ms; one packing "
          f"{coupling['pack_ms']:.4f} ms")
    print(f"[{card}] sample_posterior pipeline, n={N_PIPELINE}: "
          f"{main_path['pipeline_s']:.4f} s (median of 3); anchor log Z "
          f"{main_path['log_z']:.4f} +/- {main_path['log_z_err']:.4f} vs "
          f"{main_path['truth']:.4f}; split chain {main_path['split_log_z']:.4f}"
          f" +/- {main_path['split_log_z_err']:.4f}, "
          f"{main_path['split_launches']['coupling']} coupling launches in "
          f"{main_path['split_n_mutations']} mutations", flush=True)
    print(f"[{card}] MAF kernel, density pass, maf_rqs(4), n={N_COUPLING}: "
          f"{maf['ms']:.4f} ms, at n={N_CHAIN} {maf[f'ms_n{N_CHAIN}']:.4f} ms; "
          f"the kernel alone {maf['kernel_ms']:.4f} ms, at n={N_CHAIN} "
          f"{maf[f'kernel_ms_n{N_CHAIN}']:.4f} ms (plain torch {maf['plain_ms']:.4f} ms; through "
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
    from aspire_tpu_torch.ops import fused_mutation as FM

    nsf4, maf4 = nsf_tpu(4), maf_rqs(4)
    # B2: one flow density per step and one for the start, z0 read, z and
    # four per-particle outputs written, the packed weights read once; the
    # conditioner's first layer on the FP32 pipe, its two wide ones on the
    # tensor cores in split TF32.
    b2_first, b2_wide = ((CHAIN_STEPS + 1) * N_PIPELINE * f
                         for f in coupling_flop_parts(nsf4))
    b2_bound = bound(
        b2_first, N_PIPELINE * (2 * 4 + 4) * 4
        + 4 * nsf4.n_layers * FM.chain_layout(nsf4)[0], tensor_flop=b2_wide)
    print(f"[{card}] chain kernel, n={N_PIPELINE}, {CHAIN_STEPS} steps: "
          f"{chain_t['ms']:.4f} ms, the kernel alone "
          f"{chain_t['kernel_ms']:.4f} ms (plain torch "
          f"{chain_t['plain_ms']:.4f} ms; bound {b2_bound['bound_ms']:.4f} "
          f"ms, split TF32)")
    # B4: the first MADE layer on the FP32 pipe, the two wide ones on the
    # tensor cores in split TF32 (three products each).
    fp32_flop, tensor_flop = maf_flop(maf4)
    b4_bound, b4_bound_small = (bound(
        m * fp32_flop,
        density_bytes(maf4, m, 4 * maf4.n_layers * FC.maf_layer_floats(maf4)),
        tensor_flop=m * tensor_flop)
        for m in (N_COUPLING, N_CHAIN))
    var = staged["variants"]
    staged_bound = {k: staged[k] for k in
                    ("bound_ms", "bound_by", "bound_fp32_ms", "bound_tf32_ms",
                     "flop", "tensor_flop", "bytes")}
    d2 = {"2": var["D1"], **{k[5:]: v for k, v in var.items()
                             if k.startswith("D2")}}
    for key, v in var.items():
        print(f"[{card}] {key}, staged coupling density pass, 4 layers, "
              f"n={N_COUPLING}: {v['ms']:.4f} ms (B1 in turns "
              f"{v['b1_ms']:.4f} ms; plain torch {v['plain_ms']:.4f} ms; "
              f"bound {staged['bound_ms']:.4f} ms FP32)")
    print(f"[{card}] uniforms kernel (D4), {uniforms['n']} draws: "
          f"{uniforms['ms']:.4f} ms (plain torch {uniforms['plain_ms']:.4f} "
          f"ms; torch.rand in turns {uniforms['library_ms']:.4f} ms; kernels "
          f"alone {uniforms['kernel_ms']:.4f} ms vs torch.rand's "
          f"{uniforms['library_kernel_ms']:.4f} ms; bound "
          f"{uniforms['bound_ms']:.4f} ms); probe (8, 256) seed "
          f"{PROBE_SEED}: {uniforms['probe']}", flush=True)
    kernels = [
        {"name": "coupling_kernel (B1 density / B3 sampling)",
         "route": "cuda", "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches": sum(main_path[k]["coupling"]
                         for k in ("launches", "split_launches")),
         "launches_fused_anchor": main_path["launches"]["coupling"],
         "launches_split_anchor": main_path["split_launches"]["coupling"],
         "split_anchor_mutations": main_path["split_n_mutations"],
         "max_abs_err": coupling["max_abs_err"],
         **coupling_entry(coupling, "nsf-tpu"), "library_ms": None,
         "wrapper_ms": coupling["wrapper_ms"],
         "pack_ms": coupling["pack_ms"],
         "affine": coupling_entry(coupling, "realnvp"),
         "nsf_7_layers": coupling_entry(coupling, "nsf-7")},
        {"name": "chain_kernel (B2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/chain.cu",
         "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
         "launches": main_path["launches"]["chain"],
         "max_abs_err": chain["max_abs_err"],
         "ms": chain_t["ms"], "ms_single_call": chain_t["ms_single_call"],
         "kernel_ms": chain_t["kernel_ms"],
         "plain_ms": chain_t["plain_ms"], **b2_bound, "library_ms": None},
        {"name": "maf_kernel (B4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/maf.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:598",
         "launches": maf_path["launches"]["maf"],
         "max_abs_err": maf["max_abs_err"],
         "ms": maf["ms"], "ms_single_call": maf["ms_single_call"],
         "kernel_ms": maf["kernel_ms"],
         f"kernel_ms_n{N_CHAIN}": maf[f"kernel_ms_n{N_CHAIN}"],
         "plain_ms": maf["plain_ms"], **b4_bound, "library_ms": None,
         f"ms_n{N_CHAIN}": maf[f"ms_n{N_CHAIN}"],
         f"ms_single_call_n{N_CHAIN}": maf[f"ms_single_call_n{N_CHAIN}"],
         f"bound_ms_n{N_CHAIN}": b4_bound_small["bound_ms"],
         "wrapper_ms": maf["wrapper_ms"]},
        {"name": "staged_kernel interleaved (D1)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/interleave_ab.py:122",
         "launches": staged["launches"]["D1"],
         "max_abs_err": var["D1"]["max_abs_err"],
         "ms": var["D1"]["ms"], "ms_single_call": var["D1"]["ms_single_call"],
         "kernel_ms": var["D1"]["kernel_ms"],
         "plain_ms": var["D1"]["plain_ms"],
         **staged_bound, "library_ms": None, "b1_ms": var["D1"]["b1_ms"]},
        {"name": "staged_kernel q (D2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/quad_interleave_ab.py:96",
         "launches": staged["launches"]["D2"],
         "max_abs_err": max(v["max_abs_err"] for v in d2.values()),
         "ms": var["D2 q=4"]["ms"],
         "ms_single_call": var["D2 q=4"]["ms_single_call"],
         "kernel_ms": var["D2 q=4"]["kernel_ms"],
         "plain_ms": var["D2 q=4"]["plain_ms"],
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
         "ms": var["D3"]["ms"], "ms_single_call": var["D3"]["ms_single_call"],
         "kernel_ms": var["D3"]["kernel_ms"],
         "plain_ms": var["D3"]["plain_ms"],
         **staged_bound, "library_ms": None, "b1_ms": var["D3"]["b1_ms"],
         "micro_ms": var["D3 micro"]["ms"],
         "micro_plain_ms": var["D3 micro"]["plain_ms"]},
        {"name": "prng_uniforms (D4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/prng.cu",
         "replaces": "benchmarks/dev/prng_probe.py:15",
         "launches": uniforms["launches"],
         "max_abs_err": uniforms["max_abs_err"],
         "ms": uniforms["ms"], "ms_single_call": uniforms["ms_single_call"],
         "kernel_ms": uniforms["kernel_ms"],
         "plain_ms": uniforms["plain_ms"],
         **{k: uniforms[k] for k in ("bound_ms", "bound_by", "flop",
                                     "bytes")},
         "library_ms": uniforms["library_ms"],
         "library_ms_single_call": uniforms["library_ms_single_call"],
         "library_kernel_ms": uniforms["library_kernel_ms"],
         "turns_ms": uniforms["turns_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--chain-ab":
        print(card_line(), flush=True)
        print(json.dumps({"chain_ab": chain_ab(sys.argv[2])}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 3 and sys.argv[1] == "--coupling-ab":
        print(card_line(), flush=True)
        print(json.dumps({"coupling_ab": coupling_ab(sys.argv[2])}),
              flush=True)
        sys.exit(0)
    sys.exit(main())
