#!/usr/bin/env python3
"""Drive aspire_tpu_torch's main path on one NVIDIA GPU and check its kernels.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero), the
main paths (6, 7, 8) right after the build:
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
   pipeline on the device ladder, auto-selected, timed in turns with the
   host ladder (``ladder_turns``: each device run replays the cached graph
   once per rung, with >= 1 chain-kernel launch per rung counted per
   replay; log Z against the host ladder's and the truth), one replayed
   rung against the eager body, every state tensor bit for bit
   (``replay_check``; the kernels one replay runs, read by the profiler
   at the end of the run, against the launches its capture counted), and
   the device ladder on the split chain (>= n_steps + 2 coupling-kernel
   launches per rung; ``replay_check`` again);
   then a target that reads back to the host (``phase_uncapturable_target``:
   the host ladder by default, ValueError when the device ladder is
   forced);
7. the MAF path: fit a maf-rqs flow to the same draws, SMC at n = 8192
   (log Z against the analytic value, every mutation on the split chain,
   every density pass of it on the MAF kernel: launch counts), the
   default flow_backend ("maf", affine, plain torch) at n = 8192, then
   the maf-rqs 131072-particle pipeline, device ladder against host ladder
   in turns (>= n_steps + 2 MAF-kernel launches per rung;
   ``replay_check``);
8. BASELINE config 5 (``phase_hierarchical``): the d = 32 hierarchical
   posterior with an nsf 6 x (128, 128), 8-bin flow at its full width
   and n: B1/B3 at that shape against plain at n = 16384 and 1048576, B2
   on the hierarchical target against the plain chain at 8192 x 32 steps;
   the pipeline (fit on 32768 draws, importance sampling on 262144, SMC on
   1048576 particles with 32-step tpCN: every mutation on B2, the draws
   on B3; launch counts; the device ladder, captured on this run, then
   timed in turns with the host ladder; ``replay_check``); the
   whole-chain and split routes (every split density pass on B1)
   agreeing on log Z at n = 131072; the log Z printed beside the
   quadrature truth and the reference's TPU record;
9. the staged coupling kernels (D1-D3), as the dev scripts'
   A/B runs them: their flow (4 coupling layers, (64, 64), 8 bins) at
   n = 131072, each variant through its wrapper and timed in turns with
   the coupling kernel B1 (B1, variant, variant, B1), then held against
   its plain schedule (float64 deciding f32-ill-conditioned points) and,
   but for D3 with rqs_micro, against B1 (all on the tensor cores, with
   B1's packed weights);
10. the uniforms kernel (D4): the probe's (8, 256) at seed (3, 7), the
   131072 x 8 x 20 uniforms of a 20-step chain and a draw whose size is
   no multiple of 4, bit for bit against the plain Philox stream; timed in
   turns with torch.rand (D4, torch.rand, torch.rand, D4);
11. print kernel and plain times, each kernel's bound, the kernels JSON
   line and the result line. A time is device time: one CUDA-event pair
   around 20 back-to-back calls after a warm-up (cuda_ms); the earlier
   yardstick, an event pair around each single call (cuda_ms_single), is
   kept beside it as ms_single_call, and the kernel alone, as the
   profiler's CUDA activity records it (kernel_ms), with it. Every
   kernel_ms reading is made after every event time and pipeline: once
   the profiler has traced the card, each launch costs the host more.
   A bound is the least time on the pipes the kernel computes with (for
   every kernel but D4 its split-TF32 tensor-core products beside the FP32
   pipe's first conditioner layer).

``python3 chip_smoke.py --chain-ab PARENT`` runs none of that: it times
the chain kernel B2 of the checkout at PARENT (e.g. a ``git archive`` of
the parent commit) and of this checkout in turns, each turn a process of
its own (``chain_ab``). ``--coupling-ab PARENT`` does the same for the
coupling kernel's two modes, B1 and B3, on the flows of phase 3, and
reads phase 3's check of both checkouts' kernels on 20 input draws per
flow (``coupling_ab``); ``--maf-ab PARENT`` the same for the MAF kernel
B4 (``maf_ab``); ``--staged-ab PARENT`` the same for D1, D2 at each
compiled Q, D3 and B1 on phase 9's flow, with their errors against
float64 on 20 input draws of that flow and of nsf-tpu, read by the rule
that decides an arithmetic such as a k-step sum correction
(``staged_ab``, ``mean_rule``); ``--wide-ab PARENT`` the same
for config 5's wide kernels B1, B3 and B2 at n = 1048576 and 131072,
with their errors against float64 and each checkout's ptxas report
(``wide_ab``). ``--accumulation`` reads B2's flow density (on the d = 4
chain and on config 5's) and B4 against float64 over 20 draws each
(``accumulation``). ``--ladder-profile`` profiles one warmed device-ladder
pipeline of nsf-tpu and of maf-rqs (``ladder_profile``).
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
# BASELINE config 5 (benchmarks/hierarchical.py): n, mutation steps, the
# kernel checks' smaller n and the route agreement's n.
N_HIER, HIER_STEPS, N_HIER_CHECK, N_HIER_ROUTES = 1_048_576, 32, 16384, 131072
# Its fit draws and importance draws.
N_HIER_TRAIN, N_HIER_IMPORTANCE = 32768, 262_144
# The reference's record of config 5 (benchmarks/RESULTS.md:122-130, a TPU
# v5 run of the JAX package): SMC log Z and its error.
HIER_TPU_RECORD = (-47.3499, 0.0027)


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
    # A trace can come back without the card's activity (seen once, late
    # in a run of many traces): trace again, at most twice more.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "device_time_total", 0)
                 for e in prof.key_averages() if match in e.key)
        if us > 0:
            return us / reps / 1e3
        log(f"the profiler recorded no kernel {match!r} (trace {attempt})")
    raise AssertionError(f"the profiler recorded no kernel {match!r}")


# profiler readings the phases note (kernel_ms, replay_kernels), made by
# read_kernel_ms at the end of the run: once torch.profiler has traced the
# card (CUPTI), every later launch costs the host more, so no event time
# and no pipeline may follow.
_KERNEL_MS_LATER: list = []


def kernel_ms_later(out: dict, key: str, fn, match: str,
                    reps: int = 20) -> None:
    """Note a kernel_ms reading of ``fn`` for ``out[key]``."""
    _KERNEL_MS_LATER.append(
        lambda: out.__setitem__(key, kernel_ms(fn, match, reps)))


def read_kernel_ms() -> None:
    """Make every noted profiler reading, in the order noted."""
    for reading in _KERNEL_MS_LATER:
        reading()
    _KERNEL_MS_LATER.clear()


#: the kernels of a device-ladder rung, by the name the profiler gives
#: them, and the wrapper counter of each (``launch_counts``)
LADDER_KERNELS = {"coupling_kernel": "coupling", "chain_kernel": "chain",
                  "maf_kernel": "maf"}


def replay_kernels(ladder) -> dict:
    """The kernels one replay of ``ladder``'s graph runs on the card, per
    ``LADDER_KERNELS`` name, from ``torch.profiler``'s CUDA activity,
    against the launches its capture counted (``ladder.captured``), which
    every replay adds to the wrapper counters: they must be equal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    counters = {"coupling": FC.launches, "chain": FM.launches,
                "maf": FC.maf_launches}
    made = _build.LaunchCounter.made
    counted = {k: ladder.captured[made.index(c)] for k, c in counters.items()}
    for attempt in range(3):  # a trace can come back without the card's
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ladder.graph.replay()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
        log(f"the profiler recorded no replayed kernel (trace {attempt})")
    ran = {k: sum(e.count for e in kernels if name in e.key)
           for name, k in LADDER_KERNELS.items()}
    out = {"replay_kernels": ran, "captured_launches": counted,
           "replay_device_ops": sum(e.count for e in kernels)}
    log(f"one replay's kernels on the card: {out}")
    if ran != counted:
        raise AssertionError(f"a replay ran {ran} on the card, its capture "
                             f"counted {counted}")
    return out


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


def hierarchical_flow(n_layers: int = 6):
    """BASELINE config 5's flow, as ``Aspire(flow_backend="nsf", dims=32,
    n_layers=6, n_hidden=(128, 128))`` builds it (8 bins, tail bound 5),
    at ``n_layers``."""
    from aspire_tpu_torch.flows.architectures import nsf

    return nsf(32, n_layers=n_layers, n_hidden=(128, 128))


def as_float64(params):
    return {"layers": [{"layers": [{k: v.double() for k, v in l.items()}
                                   for l in net["layers"]]}
                       for net in params["layers"]]}


def reset_launch_counts() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from aspire_tpu_torch.ops import _build

    for counter in _build.LaunchCounter.made:
        counter.reset()


def launch_counts() -> dict:
    """B1/B3's, B2's and B4's launch counts (a CUDA graph's replays add
    the launches it captured)."""
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    return {"coupling": FC.launches.count, "chain": FM.launches.count,
            "maf": FC.maf_launches.count}


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
    COUPLING_TOL (or where either is not a number), the kernel's and the
    plain path's errors against the float64 result ``exact``, and the
    tolerance there."""
    tol = COUPLING_TOL["atol"] + COUPLING_TOL["rtol"] * plain.abs()
    bad = ~((kern - plain).abs() <= tol)
    return ((kern.double() - exact).abs()[bad],
            (plain.double() - exact).abs()[bad], tol[bad].double())


def rule_holds(e_k, e_p, tol, numel: int) -> bool:
    """The card rule on ``rule_points``: a point where kernel and plain
    disagree must be ill-conditioned in float32 (the plain path itself off
    the float64 result by a comparable amount: the kernel no farther from
    it than twice the plain path plus the tolerance), and such points rare
    (at most 1e-4 of ``numel``). A kernel output that is not a number
    fails it."""
    return e_k.numel() <= 1e-4 * numel and bool(
        (e_k <= 2 * e_p + tol).all())


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


def in_chunks(fn, params, x, chunk: int = N_COUPLING):
    """``fn(params, x)`` of a plain pass, ``chunk`` rows at a time (the
    plain spline pass holds several (n, d, K) intermediates: at
    n = 1,048,576 and d = 32 each is a GB)."""
    import torch

    if x.shape[0] <= chunk:
        return fn(params, x)
    parts = [fn(params, x[i:i + chunk]) for i in range(0, x.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def coupling_outputs(device, flow: tuple, n: int, draw: int) -> dict:
    """B1 and B3 of ``flow`` (an entry of ``coupling_flows``, or config 5's
    ``(hierarchical_flow(), seed, scale)``) through the wrapper, each
    output beside the plain float32 path's and the float64 one: the
    density pass on n inputs (input draw ``draw``), the sampling pass on
    the plain path's latents, and the round trip through both kernel
    modes. Returns them with the flow's inputs and parameters."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, seed, scale = flow
    arch, params = perturbed_flow(device, seed, arch, scale)
    params64 = as_float64(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(draw)
    x = 2.0 * torch.randn((n, arch.dims), generator=gen, device=device)
    if device.type == "cuda" and not FC.should_fuse(arch, x):
        raise AssertionError("the coupling kernel refuses the flow")
    z_k, ld_k = FC.coupling_kernel_apply(arch, "forward", params, x)
    z_p, ld_p = in_chunks(arch.forward_plain, params, x)
    z_e, ld_e = in_chunks(arch.forward_plain, params64, x.double())
    x_k, li_k = FC.coupling_kernel_apply(arch, "inverse", params, z_p)
    x_p, li_p = in_chunks(arch.inverse_plain, params, z_p)
    x_e, li_e = in_chunks(arch.inverse_plain, params64, z_p.double())
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


def error_sums(kern, plain, exact, sums: dict, what: str) -> None:
    """Add the kernel's and the plain float32 path's errors against the
    float64 result to ``sums[what]``: sums of squares, sums, count."""
    import torch

    d_k, d_p = kern.double() - exact, plain.double() - exact
    acc = sums.setdefault(what, torch.zeros(5, dtype=torch.float64,
                                            device=exact.device))
    acc += torch.stack([d_k.square().sum(), d_p.square().sum(), d_k.sum(),
                        d_p.sum(), torch.tensor(float(exact.numel()),
                                                device=exact.device)])


def error_summary(sums: dict) -> dict:
    """Per output: root mean square and mean of the kernel's and the plain
    path's errors against float64 (a one-sided rounding shows as a mean
    far from 0 beside the plain path's)."""
    out = {}
    for what, acc in sums.items():
        ssk, ssp, sk, sp, m = acc.tolist()
        out[what] = {"rms_kernel": math.sqrt(ssk / m),
                     "rms_plain": math.sqrt(ssp / m),
                     "mean_kernel": sk / m, "mean_plain": sp / m,
                     "count": m}
    return out


def coupling_accuracy(device, n: int, draws: int,
                      flows: dict | None = None) -> dict:
    """The card rule on input draws 1..``draws`` of every flow of
    ``flows`` (by default ``coupling_flows`` and the 7-layer flow
    perturbed by 0.1), read rather than asserted. Per flow: the draws it misses; at the points it
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

    if flows is None:
        flows = {**coupling_flows(),
                 "nsf-7 at 0.1": (nsf(4, n_layers=7), 9, 0.1)}
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
                plain_beyond += int(((p.double() - e).abs()
                                     > COUPLING_TOL["atol"]
                                     + COUPLING_TOL["rtol"] * e.abs()).sum())
                error_sums(k, p, e, sums, what)
            if not ok:
                missed.append(draw)
        r = torch.cat(ratios)
        q = ([float(v) for v in torch.quantile(
            r, torch.tensor([0.5, 0.9, 1.0], dtype=r.dtype, device=device))]
            if r.numel() else [])
        out[name] = {"draws": draws, "missed": missed,
                     "flagged_points": int(r.numel()),
                     "ratio_q50_q90_max": q, "worst_share_of_limit": margin,
                     "plain_beyond_tol": plain_beyond,
                     "errors": error_summary(sums)}
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


def staged_flow(device):
    """The dev scripts' A/B flow and init, as D1-D3 are held to it: 4
    coupling layers, (64, 64), 8 bins, 0.1 N(0, 1) perturbation."""
    from aspire_tpu_torch.flows.architectures import Coupling

    return perturbed_flow(device, seed=6, arch=Coupling(
        dims=4, n_layers=4, n_hidden=(64, 64), transformer="rqs"))


def phase_staged_coupling(device, n: int) -> dict:
    """D1-D3 as the dev scripts' A/B runs them: ``staged_flow`` on n
    standard-normal inputs; every variant through its wrapper and timed
    in turns with B1 (B1, variant, variant, B1), with the launch counts of
    that run; then each held against its plain schedule and, but for D3
    with rqs_micro, against B1 on the same inputs. Every variant runs B1's
    pass on B1's packed weights, so B1's bound is theirs
    (``coupling_bound``)."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import staged_coupling as SC

    arch, params = staged_flow(device)
    params64 = as_float64(params)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    x = torch.randn((n, 4), generator=gen, device=device)
    x64 = x.double()
    w_mma = FC.prepare_mma_params(arch, params)  # B1's, which D1-D3 take

    def b1():
        return FC.launch_packed(arch, "forward", w_mma, x)

    def variant(apply, launch, plain, exact=None, against_b1=True):
        return dict(apply=apply, launch=launch, plain=plain, exact=exact,
                    against_b1=against_b1)

    # D1 is D2's q = 2 configuration: its run stands for that Q.
    variants = {"D1": variant(
        lambda: SC.interleaved_apply(arch, params, x),
        lambda: SC.launch_interleaved(arch, w_mma, x),
        lambda: SC.staged_plain(arch, params, x, 2, SC.sub_tile(arch, 2)))}
    for q in (q for q in SC.COMPILED_Q if q != 2):
        variants[f"D2 q={q}"] = variant(
            lambda q=q: SC.q_apply(arch, params, x, q),
            lambda q=q: SC.launch_q(arch, w_mma, x, q),
            lambda q=q: SC.staged_plain(arch, params, x, q,
                                        SC.sub_tile(arch, q)))
    s2 = SC.sub_tile(arch, 2, paired=True)
    variants["D3"] = variant(
        lambda: SC.packed_apply(arch, params, x),
        lambda: SC.launch_packed(arch, w_mma, x),
        lambda: SC.paired_plain(arch, params, x, s2))
    variants["D3 micro"] = variant(
        lambda: SC.packed_apply(arch, params, x, micro=True),
        lambda: SC.launch_packed(arch, w_mma, x, micro=True),
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
                        "paired_kernel" if key.startswith("D3")
                        else "staged_mma_kernel")
        log(f"{key} vs plain at n={n}: {results[key]}")
    return {"variants": results, "launches": launches,
            "bound": coupling_bound(arch, n)}


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


def hierarchical_chain_setup(device, n: int, steps: int, n_layers: int = 6):
    """``chain_setup`` on BASELINE config 5: the hierarchical target at
    d = 32, its flow shape perturbed by 0.05, start points from the
    problem's initial draws (seed 3), their Gaussian reference and affine
    data transform, tpCN at nu = 5 (nu + d = 37: gamma_m 18, gamma_odd 1),
    beta 0.7, initial step 0.5."""
    import numpy as np
    import torch

    from aspire_tpu_torch.models import HierarchicalProblem
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.samplers import kernels as K

    problem = HierarchicalProblem(32)
    arch, params = perturbed_flow(device, 12, hierarchical_flow(n_layers),
                                  0.05)
    cfg = FM.ChainConfig(arch, "tpcn", steps, nu=5.0, gamma_m=18,
                         gamma_odd=1)
    z0 = torch.as_tensor(problem.draw_initial_samples(
        np.random.default_rng(3), n), dtype=torch.float32, device=device)
    ref = K.fit_gaussian_reference(z0)
    dt = (z0.mean(dim=0), z0.std(dim=0))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    step0 = torch.full((n // FM.TILE,), 0.5, device=device)
    refs = (ref.mean, ref.chol, ref.inv_chol)
    return (cfg, params, z0, 0.7, step0, refs,
            problem.kernel_target(device), dt, gen)


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
    d = kern[0].shape[1]
    tau_k, mix_k = FM.combine_tile_stats(kern[6], d)
    tau_p, mix_p = FM.combine_tile_stats(plain[6], d)
    torch.testing.assert_close(tau_k, tau_p, rtol=STATS_RTOL, atol=0)
    torch.testing.assert_close(mix_k, mix_p, rtol=STATS_RTOL, atol=0)
    return max(max_err(kern[i], plain[i]) for i in range(4))


def phase_chain(device, n: int, steps: int, setup=chain_setup) -> dict:
    """B2 against the plain chain on ``setup``'s chain (``chain_setup``:
    nsf-tpu on the mixture; ``hierarchical_chain_setup``: config 5):
    injected noise, the in-kernel Philox stream against its replay, and
    Philox against independent noise."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, gen = setup(
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
    for j in range(z0.shape[1]):
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


def chain_turn() -> dict:
    """One turn of ``chain_ab``, in the checkout whose ``aspire_tpu_torch``
    the process imports: its B2 through its wrapper on ``time_chain``'s
    inputs, by events and single calls, then alone."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, _ = chain_setup(
        torch.device("cuda"), N_PIPELINE, CHAIN_STEPS)

    def chain():
        return FM.fused_mh_chain(cfg, params, z0, beta, (1, 2), step0, *refs,
                                 target, data_transform=dt)

    times = {"B2": {"ms": cuda_ms(chain),
                    "ms_single_call": cuda_ms_single(chain)}}
    times["B2"]["kernel_ms"] = kernel_ms(chain, "chain_kernel", reps=5)
    return {"times": times, "digest": digest(chain())}


def digest(tensors) -> str:
    """A SHA-256 of the tensors' bytes: equal digests, equal outputs."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def maf_turn() -> dict:
    """One turn of ``maf_ab``, in the checkout whose ``aspire_tpu_torch``
    the process imports: its B4 through ``launch_maf`` on ``phase_maf``'s
    flow at n = N_COUPLING and N_CHAIN, by events and single calls, then
    alone."""
    import torch

    from aspire_tpu_torch.flows.architectures import maf_rqs
    from aspire_tpu_torch.ops import fused_coupling as FC

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    arch, params = perturbed_flow(dev, seed=4, arch=maf_rqs(4))
    w = FC.prepare_maf_params(arch, params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    times, later = {}, []
    for n in (N_COUPLING, N_CHAIN):
        x = 2.0 * torch.randn((n, 4), generator=gen, device=dev)

        def run(x=x):
            return FC.launch_maf(arch, w, x)

        key = f"B4 n={n}"
        times[key] = {"ms": cuda_ms(run), "ms_single_call": cuda_ms_single(run)}
        later.append((key, run))
    for key, run in later:
        times[key]["kernel_ms"] = kernel_ms(run, "maf_kernel")
    return {"times": times}


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
    times, later = {}, []
    for name, (arch, seed, scale) in coupling_flows().items():
        arch, params = perturbed_flow(dev, seed, arch, scale)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        x = 2.0 * torch.randn((n, 4), generator=gen, device=dev)
        w = FC.prepare_mma_params(arch, params)
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


# One turn of an A/B (chain_ab, maf_ab, coupling_ab, staged_ab, wide_ab),
# run by a process of its own from the root of the checkout measured: this file, loaded by path,
# calls its turn function ``fn`` there, which measures the kernels of that
# checkout.
PATH_AB_TURN = """
import importlib.util, json
spec = importlib.util.spec_from_file_location("chip_smoke_turn", {here!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
print(json.dumps(cs.{fn}({args})))
"""


def path_ab(parent: str, fn: str, args: str, what: str,
            shared: tuple = ("accuracy",)) -> dict:
    """``ab_turns`` of this file's turn function ``fn(args)`` (which
    returns its times per case under "times"): the turns' times, and per
    checkout each case's times over its two turns and the entries
    ``shared`` of its first turn (the same in both: the kernels are
    deterministic)."""
    from pathlib import Path

    turns = ab_turns(parent, PATH_AB_TURN.format(
        here=str(Path(__file__).resolve()), fn=fn, args=args), what)
    cases = list(turns[0]["times"])
    return {"turns": [{"checkout": t["checkout"], **t["times"]}
                      for t in turns], **{
        name: {**{case: {key: sum(t["times"][case][key] for t in turns
                                  if t["checkout"] == name) / 2
                         for key in ("ms", "ms_single_call", "kernel_ms")}
                  for case in cases},
               **{key: next(t[key] for t in turns if t["checkout"] == name)
                  for key in shared}}
        for name in ("parent", "change")}}


def chain_ab(parent: str) -> dict:
    """B2 of the checkout at ``parent`` against this one's, at
    n = N_PIPELINE and CHAIN_STEPS steps, in turns (parent, change, change,
    parent) on the same card; each turn a process of its own, which builds
    its checkout's kernels (a first call, not timed) and reads the kernel
    alone after its events (``chain_turn``); and whether both checkouts'
    outputs are the same bits (``digest``, for beta 0.7 and seed (1, 2))."""
    out = path_ab(parent, "chain_turn", "", "chain", ("digest",))
    out["outputs_identical"] = (out["parent"]["digest"]
                                == out["change"]["digest"])
    return out


def maf_ab(parent: str) -> dict:
    """B4 of the checkout at ``parent`` against this one's, at
    n = N_COUPLING and N_CHAIN, in turns (parent, change, change, parent),
    each turn a process of its own as in ``chain_ab`` (``maf_turn``)."""
    return path_ab(parent, "maf_turn", "", "maf", ())


def coupling_ab(parent: str, draws: int = 20) -> dict:
    """B1 (density) and B3 (sampling) of the checkout at ``parent``
    against this one's, for every flow of ``coupling_flows`` at
    n = N_COUPLING, in turns (parent, change, change, parent) on the same
    card, each turn a process of its own as in ``chain_ab``: their times,
    and the card rule read on ``draws`` input draws per flow (the same in
    both turns of a checkout: the kernels are deterministic)."""
    return path_ab(parent, "coupling_turn", f"{N_COUPLING}, {draws}",
                   "coupling")


def staged_launchers(arch, params) -> dict:
    """D1, D2 at each other compiled Q, D3 and B1 of the checkout whose
    ``aspire_tpu_torch`` the process imports: per name, a function of x
    that launches the kernel on weights packed once in the layout it takes
    (D3 took a per-particle ``prepare_params`` before it moved to the
    tensor cores, where it takes B1's, as D1/D2 do; the per-particle D3
    was compiled for 4-layer flows only), and what the profiler's name of
    the kernel contains (each function launches one kernel)."""
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import staged_coupling as SC

    w = FC.prepare_mma_params(arch, params)
    w_d3 = (FC.prepare_params(arch, params) if hasattr(FC, "prepare_params")
            else w)
    out = {"D1": (lambda x: SC.launch_interleaved(arch, w, x), "staged")}
    for q in (q for q in SC.COMPILED_Q if q != 2):
        out[f"D2 q={q}"] = (lambda x, q=q: SC.launch_q(arch, w, x, q),
                            "staged")
    if SC.staged_config(arch, 2, True) is not None:
        out["D3"] = (lambda x: SC.launch_packed(arch, w_d3, x), "paired")
    out["B1"] = (lambda x: FC.launch_packed(arch, "forward", w, x),
                 "coupling_kernel")
    return out


def staged_flows(device) -> dict:
    """The flows the staged kernels' errors are read on, each with the
    scale of its standard-normal inputs: the dev scripts' flow
    (``staged_flow``, as ``phase_staged_coupling`` feeds it) and nsf-tpu
    (3 layers of the same shape, as ``coupling_accuracy`` feeds it)."""
    arch, seed, scale = coupling_flows()["nsf-tpu"]
    return {"dev": (*staged_flow(device), 1.0),
            "nsf-tpu": (*perturbed_flow(device, seed, arch, scale), 2.0)}


def staged_accuracy(device, n: int, draws: int) -> dict:
    """``staged_launchers`` of every flow of ``staged_flows`` against
    float64 over input draws 1..``draws`` of n inputs: per flow and
    kernel the draws the card rule misses and the rms and mean errors of
    z and log det, the kernel's and the plain float32 pass's
    (``error_summary``)."""
    import torch

    out = {}
    for flow, (arch, params, scale) in staged_flows(device).items():
        launchers = staged_launchers(arch, params)
        params64 = as_float64(params)
        sums = {key: {} for key in launchers}
        missed = {key: [] for key in launchers}
        for draw in range(1, draws + 1):
            gen = torch.Generator(device=device)
            gen.manual_seed(draw)
            x = scale * torch.randn((n, arch.dims), generator=gen,
                                    device=device)
            plain = arch.forward_plain(params, x)
            exact = arch.forward_plain(params64, x.double())
            for key, (launch, _) in launchers.items():
                ok = True
                for what, k, p, e in zip(("z", "log_det"), launch(x), plain,
                                         exact):
                    error_sums(k, p, e, sums[key], what)
                    ok = ok and rule_holds(*rule_points(k, p, e), p.numel())
                if not ok:
                    missed[key].append(draw)
        out[flow] = {key: {"draws": draws, "n": n, "missed": missed[key],
                           "errors": error_summary(sums[key])}
                     for key in launchers}
    return out


def staged_turn(n: int, draws: int) -> dict:
    """One turn of ``staged_ab``, in the checkout whose ``aspire_tpu_torch``
    the process imports: ``staged_launchers`` on ``phase_staged_coupling``'s
    flow and inputs, each by events, single calls and then alone;
    ``staged_accuracy`` of them on ``draws`` draws; and the ptxas report of
    the staged kernels as this checkout's build logged it."""
    import torch

    from aspire_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    log_text = _build.build().with_suffix(".log").read_text()
    ptxas = {**ptxas_report(log_text, "staged"),
             **ptxas_report(log_text, "paired")}
    arch, params = staged_flow(dev)
    launchers = staged_launchers(arch, params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    x = torch.randn((n, 4), generator=gen, device=dev)
    times, later = {}, []
    for key, (launch, match) in launchers.items():
        def run(launch=launch):
            return launch(x)

        times[key] = {"ms": cuda_ms(run), "ms_single_call": cuda_ms_single(run)}
        later.append((key, run, match))
    accuracy = staged_accuracy(dev, n, draws)
    for key, run, match in later:
        times[key]["kernel_ms"] = kernel_ms(run, match)
    return {"times": times, "accuracy": accuracy, "ptxas": ptxas}


def largest_mean_ratio(accuracy: dict, key: str) -> float:
    """Kernel ``key``'s largest |mean error| / |plain float32's mean error|
    against float64 over the flows and outputs of ``staged_accuracy``'s
    ``accuracy``, counting only the outputs where plain's mean is clear of
    its noise (beyond 3 standard errors, rms / sqrt(count))."""
    ratios = [abs(e["mean_kernel"] / e["mean_plain"])
              for flow in accuracy.values()
              for e in flow[key]["errors"].values()
              if abs(e["mean_plain"]) > 3 * e["rms_plain"] / math.sqrt(
                  e["count"])]
    return max(ratios) if ratios else float("nan")


def mean_rule(accuracy: dict, other: dict, key: str) -> dict:
    """The rule that decides an arithmetic, such as a correction of the
    tensor core's cut k-step sums: kernel ``key`` of ``accuracy`` against
    the same kernel of ``other`` (say with and without the correction). It
    is kept only where, over the flows both read, its largest mean ratio
    (``largest_mean_ratio``) is at least 20% smaller than ``other``'s and
    its rms error is within 1.1x of ``other``'s on every output."""
    flows = [f for f in accuracy if key in accuracy[f] and key in other[f]]
    mine, theirs = (largest_mean_ratio({f: acc[f] for f in flows}, key)
                    for acc in (accuracy, other))
    rms = max(e["rms_kernel"] / other[f][key]["errors"][what]["rms_kernel"]
              for f in flows
              for what, e in accuracy[f][key]["errors"].items())
    return {"largest_mean_ratio": mine, "other_largest_mean_ratio": theirs,
            "rms_ratio": rms, "keeps": mine <= 0.8 * theirs and rms <= 1.1}


def staged_ab(parent: str, draws: int = 20) -> dict:
    """D1, D2 at each compiled Q, D3 and B1 of the checkout at ``parent``
    against this one's, at n = N_COUPLING, in turns (parent, change,
    change, parent) on the same card, each turn a process of its own as in
    ``chain_ab``: their times, and their errors against float64 on
    ``draws`` input draws per flow of ``staged_flows`` (the same in both
    turns of a checkout: the kernels are deterministic); each checkout's
    ptxas report of the staged kernels; and per kernel of both,
    ``mean_rule`` of the parent's arithmetic against this checkout's."""
    out = path_ab(parent, "staged_turn", f"{N_COUPLING}, {draws}", "staged",
                  ("accuracy", "ptxas"))
    acc_p, acc_c = out["parent"]["accuracy"], out["change"]["accuracy"]
    out["mean_rule_parent_over_change"] = {
        key: mean_rule(acc_p, acc_c, key)
        for key in acc_p["dev"] if key in acc_c["dev"]}
    return out


def chain_accuracy(device, draws: int = 20, n: int = N_CHAIN,
                   steps: int = CHAIN_STEPS, setup=chain_setup) -> dict:
    """B2's flow density against float64, read over ``draws`` Philox
    seeds of ``setup``'s chain: at each chain's final points, the
    kernel's lq (its flow pass at those points, in its arithmetic) and
    the plain float32 lq, each against the float64 lq."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, _ = setup(device, n,
                                                              steps)
    arch, d = cfg.arch, z0.shape[1]
    params64 = as_float64(params)

    def lq(p, x):
        xf = (x - dt[0].to(x)) / dt[1].to(x)
        z, ld = arch.forward_plain(p, xf)
        return (-0.5 * torch.sum(z * z, dim=-1) - d * 0.5 * math.log(
            2 * math.pi) + ld - torch.sum(torch.log(torch.abs(dt[1].to(x)))))

    sums = {}
    for draw in range(1, draws + 1):
        z, lq_k = FM.fused_mh_chain(cfg, params, z0, beta, (draw, 7), step0,
                                    *refs, target, data_transform=dt)[:2]
        error_sums(lq_k, lq(params, z), lq(params64, z.double()), sums,
                   "lq")
    return {"draws": draws, "n": n, "errors": error_summary(sums)}


def maf_accuracy(device, draws: int = 20, n: int = N_COUPLING) -> dict:
    """B4 against float64 over ``draws`` input draws of ``phase_maf``'s
    flow: rms and mean errors of z and log det, kernel and plain float32,
    and the draws the card rule misses."""
    import torch

    from aspire_tpu_torch.flows.architectures import maf_rqs
    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, params = perturbed_flow(device, seed=4, arch=maf_rqs(4))
    params64 = as_float64(params)
    sums, missed = {}, []
    for draw in range(1, draws + 1):
        gen = torch.Generator(device=device)
        gen.manual_seed(draw)
        x = 2.0 * torch.randn((n, 4), generator=gen, device=device)
        outs = zip(("z", "log_det"), FC.maf_kernel_apply(arch, params, x),
                   arch.forward_plain(params, x),
                   arch.forward_plain(params64, x.double()))
        ok = True
        for what, k, p, e in outs:
            error_sums(k, p, e, sums, what)
            ok = ok and rule_holds(*rule_points(k, p, e), p.numel())
        if not ok:
            missed.append(draw)
    return {"draws": draws, "n": n, "missed": missed,
            "errors": error_summary(sums)}


def accumulation() -> dict:
    """``chain_accuracy`` and ``maf_accuracy``: B2 (on the d = 4 chain and
    on config 5's, the wide form) and B4 read against float64 over 20
    draws each (their split products' accumulation)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    return {"chain": chain_accuracy(dev),
            "chain_config5": chain_accuracy(
                dev, steps=HIER_STEPS, setup=hierarchical_chain_setup),
            "maf": maf_accuracy(dev)}


def ladder_profile(top: int = 6) -> dict:
    """Where a warmed device-ladder pipeline spends its time, for nsf-tpu
    and maf-rqs at N_PIPELINE (the main paths' flows and fits): the wall
    (host clock to a synchronise), the initial draws alone, and from
    ``torch.profiler``'s CUDA activity of one pipeline the device's busy
    time (the sum of its kernels' times: one stream, so no overlap), its
    kernels' count and the ``top`` kernels by device time."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    torch.backends.cuda.matmul.allow_tf32 = False
    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    run = dict(sampler="smc", n_samples=N_PIPELINE, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    out = {}
    for name, kw in (("nsf-tpu", dict(flow_backend="nsf",
                                      architecture="nsf-tpu")),
                     ("maf-rqs", dict(flow_backend="maf-rqs"))):
        asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                     dims=4, parameters=p.parameters, seed=1, device="cuda",
                     **kw)
        asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
        for _ in range(2):  # the capture, then a warm replay
            asp.sample_posterior(**run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        asp.sampler.draw_initial_samples(N_PIPELINE)
        torch.cuda.synchronize()
        draw_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            asp.sample_posterior(**run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e6
        kernels.sort(key=lambda e: -e.self_device_time_total)
        out[name] = {
            "wall_s": wall, "draw_initial_samples_s": draw_s,
            "device_busy_s": busy, "device_busy_share": busy / wall,
            "device_ops": sum(e.count for e in kernels),
            "rungs": len(asp.sampler.history.beta),
            "top": [(e.key[:60], e.count, e.self_device_time_total / 1e3)
                    for e in kernels[:top]]}
        log(f"{name} device-ladder pipeline profile: {out[name]}")
    return out


def ptxas_report(text: str, match: str = "kernel_wide") -> dict:
    """From an ``nvcc -Xptxas -v`` log, per kernel whose mangled name
    contains ``match``: its registers and bytes of stack, spill stores and
    spill loads."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry[1] if match in entry[1] else None
            if name:
                out[name] = {}
            continue
        if name is None:
            continue
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if frame:
            out[name].update(zip(("stack", "spill_stores", "spill_loads"),
                                 map(int, frame.groups())))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[name]["registers"] = int(used[1])
    return out


def wide_turn(draws: int) -> dict:
    """One turn of ``wide_ab``, in the checkout whose ``aspire_tpu_torch``
    the process imports: config 5's B1, B3 (weights packed once, through
    ``launch_packed``) and B2 (``hierarchical_chain_setup``'s chain,
    HIER_STEPS steps) at N_HIER and N_HIER_ROUTES, by events and single
    calls, then alone; their errors against float64 (B1/B3 over ``draws``
    input draws at N_HIER_CHECK, B2's lq over ``draws`` Philox seeds at
    N_CHAIN); and the ptxas report of the wide kernels as this checkout's
    build logged it."""
    import torch

    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    ptxas = ptxas_report(_build.build().with_suffix(".log").read_text())
    arch, params = perturbed_flow(dev, 12, hierarchical_flow(), 0.05)
    w = FC.prepare_mma_params(arch, params)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    times, later = {}, []
    for n, reps, chain_reps in ((N_HIER, 5, 3), (N_HIER_ROUTES, 20, 10)):
        x = 2.0 * torch.randn((n, 32), generator=gen, device=dev)
        z = in_chunks(arch.forward_plain, params, x)[0]
        for name, mode, inp in (("B1", "forward", x), ("B3", "inverse", z)):
            def run(mode=mode, inp=inp):
                return FC.launch_packed(arch, mode, w, inp)

            key = f"{name} n={n}"
            times[key] = {"ms": cuda_ms(run, reps),
                          "ms_single_call": cuda_ms_single(run, reps)}
            later.append((key, run, "coupling_kernel_wide", reps))
        cfg, cparams, z0, beta, step0, refs, target, dt, _ = (
            hierarchical_chain_setup(dev, n, HIER_STEPS))

        def chain(cfg=cfg, cparams=cparams, z0=z0, beta=beta, step0=step0,
                  refs=refs, target=target, dt=dt):
            return FM.fused_mh_chain(cfg, cparams, z0, beta, (1, 2), step0,
                                     *refs, target, data_transform=dt)

        key = f"B2 n={n}"
        times[key] = {"ms": cuda_ms(chain, chain_reps),
                      "ms_single_call": cuda_ms_single(chain, chain_reps)}
        later.append((key, chain, "chain_kernel_wide", chain_reps))
        del x, z, z0
    accuracy = {"coupling": coupling_accuracy(
                    dev, N_HIER_CHECK, draws,
                    {"config 5": (hierarchical_flow(), 12, 0.05)}),
                "chain": chain_accuracy(dev, draws, N_CHAIN, HIER_STEPS,
                                        setup=hierarchical_chain_setup)}
    for key, run, match, reps in later:
        times[key]["kernel_ms"] = kernel_ms(run, match, reps)
    return {"times": times, "accuracy": accuracy, "ptxas": ptxas}


def wide_ab(parent: str, draws: int = 10) -> dict:
    """Config 5's wide kernels B1, B3 and B2 of the checkout at ``parent``
    against this one's, at N_HIER and N_HIER_ROUTES, in turns (parent,
    change, change, parent) on the same card, each turn a process of its
    own as in ``chain_ab`` (``wide_turn``): their times by events and
    alone, their errors against float64 on ``draws`` draws (the same in
    both turns of a checkout: the kernels are deterministic), and each
    checkout's ptxas report of its wide kernels."""
    return path_ab(parent, "wide_turn", f"{draws}", "wide",
                   ("accuracy", "ptxas"))


def ladder_turns(asp, run: dict, need: dict, truth: float | None = None,
                 warm: bool = True) -> dict:
    """The default path, the device ladder auto-selected, against the
    host ladder (``device_ladder=False``) on ``run``, in turns (device,
    host, host, device, device, host) after a warm-up of each: host clock
    to ``torch.cuda.synchronize()``, medians of 3. Every device run must
    take the ladder's graph, replay it once per rung when the ladder came
    from ``asp.ladder_cache``, and launch each kernel of ``need`` at least
    that many times per rung (a replay counts what its graph captured).
    The last runs' log Z must agree within max(5 combined sigma, 0.15),
    and each pass ``check_result`` when ``truth`` is given. On the card
    every run of a ladder must give the population its first run gave
    (one seed repeats a run: the resampling sums in a fixed order);
    whether the two ladders give one population is reported.
    ``warm=False`` when the caller's own run was the device ladder's
    warm-up."""
    import torch

    turns = ["device", "host", "host", "device", "device", "host"]
    runs = (["device", "host"] if warm else []) + turns
    walls = {"device": [], "host": []}
    last, first, repeats = {}, {}, {"device": True, "host": True}
    on_card = asp.device.type == "cuda"
    for i, ladder in enumerate(runs):
        replays = {id(v[1]): v[1].replays for v in asp.ladder_cache.values()}
        reset_launch_counts()
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        post, hist = asp.sample_posterior(
            **run, return_history=True,
            device_ladder=None if ladder == "device" else False)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if i >= len(runs) - len(turns):
            walls[ladder].append(wall)
        lad, rungs = asp.sampler.ladder, len(hist.beta)
        log(f"{ladder} ladder run {i}: {wall:.4f} s, {rungs} rungs"
            + (f", {lad.replays - replays.get(id(lad), 0)} replays"
               f"{'' if id(lad) in replays else ' (captured)'}"
               if lad is not None else ""))
        if ladder == "host":
            if lad is not None:
                raise AssertionError("device_ladder=False took the device "
                                     "ladder")
        elif lad is None or (on_card and lad.graph is None):
            raise AssertionError("the default path did not take the device "
                                 "ladder's graph")
        else:
            replayed = lad.replays - replays.get(id(lad), 0)
            counts = launch_counts()
            if on_card and ((id(lad) in replays and replayed != rungs) or any(
                    counts[k] < v * rungs for k, v in need.items())):
                raise AssertionError(
                    f"device ladder: {replayed} replays for {rungs} rungs, "
                    f"launches {counts}, need per rung {need}")
            last.update(capture_s=lad.capture_s, launches=counts)
        last[ladder] = (post, rungs)
        if ladder in first:
            repeats[ladder] &= torch.equal(first[ladder], post.x)
        else:
            first[ladder] = post.x
    (dpost, rungs), (hpost, host_rungs) = last["device"], last["host"]
    tol = max(5 * math.hypot(dpost.log_evidence_error,
                             hpost.log_evidence_error), 0.15)
    if abs(dpost.log_evidence - hpost.log_evidence) >= tol:
        raise AssertionError(
            f"ladders disagree on log Z: device {dpost.log_evidence} +/- "
            f"{dpost.log_evidence_error}, host {hpost.log_evidence} +/- "
            f"{hpost.log_evidence_error}")
    if truth is not None:
        for post in (dpost, hpost):
            check_result(post, run["n_samples"], truth)
    out = {"device_s": sorted(walls["device"])[1],
           "host_s": sorted(walls["host"])[1],
           "device_walls_s": walls["device"], "host_walls_s": walls["host"],
           "rungs": rungs, "host_rungs": host_rungs,
           "capture_s": last["capture_s"], "launches": last["launches"],
           "log_z": dpost.log_evidence, "log_z_err": dpost.log_evidence_error,
           "host_log_z": hpost.log_evidence,
           "host_log_z_err": hpost.log_evidence_error, "tolerance": tol,
           "runs_repeat": repeats,
           "ladders_agree_bitwise": torch.equal(first["device"],
                                                first["host"])}
    log(f"ladders in turns: {out}")
    if on_card and not all(repeats.values()):
        raise AssertionError(f"one seed did not repeat a run: {repeats}")
    return out


def replay_check(asp) -> dict:
    """One rung replayed from the graph of the device ladder in
    ``asp.ladder_cache`` (the last one a run of ``asp`` captured), on
    ``asp.sampler`` (a run of the same options), against its body run
    eagerly twice,
    from the same state (the sampler's initial draws at beta 0) and the
    same generator state: every state tensor (the particles and their
    densities after the mutation, the step sizes, the history buffers, the
    flags) and the generator state after the rung must be the same bits
    in all three. The body sums in fixed orders on the card (the
    resampling's CDF by ``resampling.rowwise_cumsum``), so its eager runs
    repeat; a replay that froze a value of the capture (B2's beta or seed,
    a packed weight) or lost an update differs. Notes a profiler reading of
    the kernels one replay runs (``replay_kernels``) for the end of the
    run, under ``replay_kernels``."""
    import torch

    from aspire_tpu_torch.samples import SMCSamples

    (_, lad), = asp.ladder_cache.values()
    sampler = asp.sampler
    if lad.graph is None:
        raise AssertionError("the device ladder was never captured")
    n = lad.state["x"].shape[0]
    init = SMCSamples.from_samples(sampler.draw_initial_samples(n), beta=0.0,
                                   dtype=sampler.dtype)
    sampler._load_ladder(lad.state, init, min_beta_step=0.0,
                         max_beta_step=1.0, beta_tolerance=1e-8,
                         max_iters=lad.state["beta_h"].numel())
    start = {k: v.clone() for k, v in lad.state.items()}
    gen0 = lad.generator.get_state()

    def from_start(step):
        for k, v in start.items():
            lad.state[k].copy_(v)
        lad.generator.set_state(gen0)
        step()
        torch.cuda.synchronize()
        return ({k: v.clone() for k, v in lad.state.items()},
                lad.generator.get_state())

    replay, gen_replay = from_start(lad.graph.replay)
    eager, gen_eager = from_start(lambda: lad.body(lad.state))
    again, gen_again = from_start(lambda: lad.body(lad.state))
    differ = sorted(k for k in replay if not torch.equal(replay[k], eager[k]))
    repeat = sorted(k for k in again if not torch.equal(again[k], eager[k]))
    moved = bool((replay["x"] != start["x"]).any())
    out = {"route": sampler.history.mutation_route[-1], "n": n,
           "fields": len(replay), "differ": differ,
           "differ_between_eager_runs": repeat,
           "random_numbers_equal": bool(torch.equal(gen_replay, gen_eager)
                                        and torch.equal(gen_again, gen_eager)),
           "beta": float(replay["beta"]),
           "acceptance": float(replay["acc_h"][0]),
           "particles_moved": moved}
    log(f"graph replay vs eager rung: {out}")
    if differ or repeat or not out["random_numbers_equal"] or not moved:
        raise AssertionError(f"graph replay vs eager rung: {out}")
    _KERNEL_MS_LATER.append(lambda: out.update(replay_kernels(lad)))
    return out


def phase_device_ladder_check(device, n: int) -> dict:
    """``replay_check`` on a device-ladder run of the main path's flow
    (nsf-tpu fitted as ``phase_main_path`` fits it) at ``n``."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    run = dict(sampler="smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    check_result(asp.sample_posterior(**run), n, p.true_log_evidence())
    return {"replay_vs_eager": replay_check(asp)}


def phase_uncapturable_target(device, n: int) -> dict:
    """A target that reads a value back to the host cannot be captured:
    ``target_is_capturable`` says so before any ladder capture, the
    default path then runs the host ladder (log Z against the truth) and
    ``device_ladder=True`` raises ``ValueError``. The card runs on after
    the failed capture (the next phases launch every kernel)."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)

    def log_likelihood(samples):
        out = p.log_likelihood(samples)
        if float(out.max()) > 1e30:  # a host read, as user code may do
            raise ValueError("log likelihood out of range")
        return out

    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    run = dict(sampler="smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    post = asp.sample_posterior(**run)
    check_result(post, n, p.true_log_evidence())
    out = {"auto": "host" if asp.sampler.ladder is None else "device",
           "capturable": asp.sampler.target_is_capturable()}
    try:
        asp.sample_posterior(**run, device_ladder=True)
        out["forced"] = "ran"
    except ValueError:
        out["forced"] = "ValueError"
    log(f"a target with a host read: {out}")
    if out != {"auto": "host", "capturable": False, "forced": "ValueError"}:
        raise AssertionError(f"a target with a host read: {out}")
    return out


def phase_main_path(device, n_anchor: int, n_pipeline: int) -> dict:
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

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
    launches = launch_counts()
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
    split_launches = launch_counts()
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

    # The pipeline: the default path takes the device ladder (B2 once per
    # rung), timed in turns with the host ladder; then the ladder on the
    # split chain (every density pass on B1, counted per replay).
    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    store_sample_history=False,
                    sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    on_card = device.type == "cuda"
    ladders = ladder_turns(asp, pipeline, {"chain": 1}, truth)
    replay = replay_check(asp) if on_card else None
    split_pipeline = dict(pipeline, sampler_kwargs=dict(
        n_steps=CHAIN_STEPS, fused_chain=False))
    ladder_split = ladder_turns(asp, split_pipeline,
                                {"coupling": CHAIN_STEPS + 2}, truth)
    replay_split = replay_check(asp) if on_card else None
    return {"launches": launches, "log_z": samples.log_evidence,
            "log_z_err": samples.log_evidence_error, "truth": truth,
            "pipeline_s": ladders["device_s"],
            "pipeline_walls_s": ladders["device_walls_s"],
            "ladders": ladders, "ladders_split": ladder_split,
            "replay_vs_eager": replay, "replay_vs_eager_split": replay_split,
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

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.flows.architectures import MAF
    from aspire_tpu_torch.models import GaussianMixtureProblem

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
    launches = launch_counts()
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

    # The pipeline on the device ladder (every density pass of its split
    # chains on B4, counted per replay), timed in turns with the host one.
    ladders = ladder_turns(asp, dict(n_samples=n_pipeline,
                                     store_sample_history=False, **run_kw),
                           {"maf": CHAIN_STEPS + 2}, truth)
    replay = replay_check(asp) if device.type == "cuda" else None
    return {"launches": launches, "log_z": samples.log_evidence,
            "log_z_err": samples.log_evidence_error, "truth": truth,
            "default_log_z": dpost.log_evidence,
            "default_log_z_err": dpost.log_evidence_error,
            "pipeline_s": ladders["device_s"],
            "pipeline_walls_s": ladders["device_walls_s"],
            "ladders": ladders, "replay_vs_eager": replay,
            "n_mutations": len(routes)}


def hierarchical_truth() -> dict:
    """log Z of config 5's target by quadrature (theta integrates out):
    the problem's trapezoid grid in numpy, and scipy's dblquad."""
    import numpy as np
    from scipy import integrate

    from aspire_tpu_torch.models import HierarchicalProblem

    p = HierarchicalProblem(32)
    grid = p.log_evidence_quadrature()
    y = np.asarray(p.y_obs)

    def density(s, m):
        var = 1.0 + math.exp(2.0 * s)
        log_f = (-0.5 * float(np.sum((y - m) ** 2)) / var
                 - 0.5 * y.size * math.log(2 * math.pi * var)
                 - 0.5 * m * m / 25.0 - 0.5 * math.log(2 * math.pi * 25.0)
                 - 0.5 * s * s - 0.5 * math.log(2 * math.pi))
        return math.exp(log_f - grid)

    value, _ = integrate.dblquad(density, -15.0, 15.0, -10.0, 10.0,
                                 epsabs=1e-12, epsrel=1e-10)
    return {"grid": grid, "dblquad": grid + math.log(value)}


def coupling_times(arch, params, x, z, out: dict, key: str = "",
                   reps: int = 20) -> None:
    """B1 and B3 of ``arch`` on x (density) and z (sampling), weights
    packed once, into ``out``: events and single calls (at config 5's
    milliseconds a call, host work is no part of either)."""
    from aspire_tpu_torch.ops import fused_coupling as FC

    w = FC.prepare_mma_params(arch, params)
    for mode, prefix, inp in (("forward", "", x), ("inverse", "inverse_", z)):
        def run(mode=mode, inp=inp):
            return FC.launch_packed(arch, mode, w, inp)

        out[prefix + "ms" + key] = cuda_ms(run, reps)
        out[prefix + "ms_single_call" + key] = cuda_ms_single(run, reps)


def chain_bound(arch, n: int, steps: int) -> dict:
    """B2's bound for one ``steps``-step chain of n particles: one flow
    density per step and one for the start (the first conditioner layer
    on the FP32 pipe, the two wide ones on the tensor cores in split
    TF32); z0 read, z and four per-particle outputs written, the packed
    weights read once."""
    from aspire_tpu_torch.ops import fused_mutation as FM

    first, wide = ((steps + 1) * n * f for f in coupling_flop_parts(arch))
    return bound(first, n * (2 * arch.dims + 4) * 4
                 + 4 * arch.n_layers * FM.chain_layout(arch)[0],
                 tensor_flop=wide)


def phase_hierarchical(device) -> dict:
    """BASELINE config 5 (benchmarks/hierarchical.py) at its full width:
    the d = 32 hierarchical posterior, nsf 6 x (128, 128), 8 bins.

    1. B1 and B3 at the config's flow shape against the plain pass (float64
       deciding the points where they disagree), at N_HIER_CHECK and N_HIER;
       B2 on the hierarchical target against the plain chain (injected
       noise, Philox replay, independent noise) at 8192 x HIER_STEPS.
    2. The pipeline, launch counts from 0: fit on 32,768 draws (20 epochs,
       batch 1024), importance sampling on 262,144 draws, SMC on N_HIER
       particles with HIER_STEPS-step tpCN mutations: every mutation on
       B2 (one launch per temperature), the initial and importance draws on
       B3.
    3. Route agreement at N_HIER_ROUTES: the whole-chain route and the
       split chain (fused_chain=False, every density pass on B1: at least
       HIER_STEPS + 2 launches per mutation) agree on log Z within
       max(5 combined sigma, 0.15).
    4. Printed beside the run's log Z, not asserted: the quadrature truth
       and the reference's TPU record (the reference's SMC sits below the
       truth; PERF.md section 7).
    Then the kernels' times at the config's n (plain torch at
    N_HIER_ROUTES).
    """
    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import HierarchicalProblem
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    out = {"truth": hierarchical_truth()}
    log(f"config 5 quadrature log Z: {out['truth']}")

    # 1. The kernels at the config's shape.
    flow = (hierarchical_flow(), 12, 0.05)
    checks = {}
    for n in (N_HIER_CHECK, N_HIER):
        c = coupling_outputs(device, flow, n, 1)
        bad = {what: assert_kernel_close(*v, f"config 5 {what}, n={n}")
               for what, v in c["outputs"].items()}
        err = max(max_err(k, p) for what, (k, p, _) in c["outputs"].items()
                  if not what.startswith("round trip"))
        checks[n] = {"max_abs_err": err, "ill_conditioned_points": bad}
        log(f"config 5 coupling kernel vs plain at n={n}: {checks[n]}")
    out["coupling_checks"] = checks
    out["chain_check"] = phase_chain(device, N_CHAIN, HIER_STEPS,
                                     setup=hierarchical_chain_setup)

    # 2. The pipeline.
    problem = HierarchicalProblem(32)
    initial = Samples(problem.draw_initial_samples(np.random.default_rng(7),
                                                   N_HIER_TRAIN))
    asp = Aspire(log_likelihood=problem.log_likelihood,
                 log_prior=problem.log_prior, dims=32, flow_backend="nsf",
                 n_layers=6, n_hidden=(128, 128), seed=3, device=device)
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asp.fit(initial, n_epochs=20, batch_size=1024)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    arch = asp.flow.architecture
    if FC.config_id(arch) != 2 or arch.n_layers != 6:
        raise AssertionError(f"config 5's flow is not configuration 2: {arch}")
    t0 = time.perf_counter()
    is_post = asp.sample_posterior(sampler="importance",
                                   n_samples=N_HIER_IMPORTANCE)
    torch.cuda.synchronize()
    importance_s = time.perf_counter() - t0
    is_launches = FC.launches.count
    smc_run = dict(sampler="smc", n_samples=N_HIER,
                   sampler_kwargs=dict(n_steps=HIER_STEPS),
                   store_sample_history=False)
    t0 = time.perf_counter()
    post, hist = asp.sample_posterior(**smc_run, return_history=True)
    torch.cuda.synchronize()
    smc_s = time.perf_counter() - t0
    capture_s = asp.sampler.ladder.capture_s
    launches = {**launch_counts(), "coupling_importance": is_launches}
    routes = hist.mutation_route
    log(f"config 5 pipeline: fit {fit_s:.2f} s, importance "
        f"{importance_s:.2f} s, SMC {smc_s:.2f} s, "
        f"{len(hist.beta)} temperatures, routes {set(routes)}, launches "
        f"{launches}; log Z {post.log_evidence:.4f} +/- "
        f"{post.log_evidence_error:.4f}, importance "
        f"{float(is_post.log_evidence):.4f} +/- "
        f"{float(is_post.log_evidence_error):.4f}")
    on_card = device.type == "cuda"
    if set(routes) != {"fused_kernel"} or len(routes) != len(hist.beta) or (
            on_card and launches["chain"] != len(routes)):
        raise AssertionError(f"config 5 mutations left B2: {routes}, "
                             f"{launches}, {len(hist.beta)} temperatures")
    # The importance draws, then SMC's initial draws: B3 each time.
    if on_card and (is_launches < 1 or launches["coupling"] < 2):
        raise AssertionError(f"config 5 draws left B3: {launches}")
    for samples, n in ((post, N_HIER), (is_post, N_HIER_IMPORTANCE)):
        if tuple(samples.x.shape) != (n, 32) or not bool(
                torch.isfinite(samples.x).all()):
            raise AssertionError("config 5 samples are not finite (n, 32)")
    if not (math.isfinite(post.log_evidence)
            and math.isfinite(post.log_evidence_error)):
        raise AssertionError("config 5 log Z is not finite")
    # The device ladder (this run's was its capture) against the host one.
    ladders = ladder_turns(asp, smc_run, {"chain": 1}, warm=False)
    replay = replay_check(asp) if on_card else None

    # 3. Route agreement.
    routes_out = {}
    for route, kw in (("fused_kernel", {}), ("split", {"fused_chain": False})):
        reset_launch_counts()
        r, h = asp.sample_posterior(
            sampler="smc", n_samples=N_HIER_ROUTES,
            sampler_kwargs=dict(n_steps=HIER_STEPS, **kw),
            store_sample_history=False, return_history=True)
        n_mut = len(h.mutation_route)
        counts = launch_counts()
        routes_out[route] = {"log_z": r.log_evidence,
                             "log_z_err": r.log_evidence_error,
                             "n_mutations": n_mut, "launches": counts}
        log(f"config 5 at n={N_HIER_ROUTES}, {route}: {routes_out[route]}")
        if set(h.mutation_route) != {route}:
            raise AssertionError(f"{route} run took {h.mutation_route}")
        if on_card and route == "split" and (
                counts["chain"] or counts["coupling"]
                < (HIER_STEPS + 2) * n_mut):
            raise AssertionError(
                f"the split chain's density passes left B1: {counts}, need "
                f">= {(HIER_STEPS + 2) * n_mut}")
        if on_card and route == "fused_kernel" and counts["chain"] != n_mut:
            raise AssertionError(f"fused run: {counts}, {n_mut} mutations")
    a, b = routes_out["fused_kernel"], routes_out["split"]
    tol = max(5 * math.hypot(a["log_z_err"], b["log_z_err"]), 0.15)
    if abs(a["log_z"] - b["log_z"]) >= tol:
        raise AssertionError(f"routes disagree on log Z: {a} vs {b}")
    out.update({
        "fit_s": fit_s, "importance_s": importance_s, "smc_wall_s": smc_s,
        "smc_capture_s": capture_s, "ladders": ladders,
        "replay_vs_eager": replay, "n_temperatures": len(hist.beta),
        "log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
        "log_z_importance": float(is_post.log_evidence),
        "log_z_importance_err": float(is_post.log_evidence_error),
        "launches": launches, "routes": routes_out,
        "routes_tolerance": tol,
        "mutation_particle_steps_per_s":
            N_HIER * HIER_STEPS * len(routes) / smc_s})

    if not on_card:
        return out
    # Times at the config's n; plain torch at N_HIER_ROUTES.
    arch, params = perturbed_flow(device, 12, hierarchical_flow(), 0.05)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    times = {}
    for n, key, reps in ((N_HIER, "", 5), (N_HIER_ROUTES, "_n131072", 20)):
        x = 2.0 * torch.randn((n, 32), generator=gen, device=device)
        z = in_chunks(arch.forward_plain, params, x)[0]
        coupling_times(arch, params, x, z, times, key, reps)
        if n == N_HIER_ROUTES:
            times["plain_ms"] = cuda_ms(
                lambda: arch.forward_plain(params, x), 3)
            times["inverse_plain_ms"] = cuda_ms(
                lambda: arch.inverse_plain(params, z), 3)
    out["coupling_times"] = times
    chain = {}
    for n, key, reps in ((N_HIER, "", 2), (N_HIER_ROUTES, "_n131072", 5)):
        cfg, cparams, z0, beta, step0, refs, target, dt, _ = (
            hierarchical_chain_setup(device, n, HIER_STEPS))

        def kernel(cfg=cfg, cparams=cparams, z0=z0, step0=step0, refs=refs,
                   target=target, dt=dt):
            return FM.fused_mh_chain(cfg, cparams, z0, 0.7, (1, 2), step0,
                                     *refs, target, data_transform=dt)

        chain["ms" + key] = cuda_ms(kernel, reps)
        chain["ms_single_call" + key] = cuda_ms_single(kernel, reps)
        if n == N_HIER_ROUTES:
            chain["plain_ms"] = cuda_ms(lambda: FM.chain_plain(
                cfg, cparams, z0, 0.7, step0, *refs, target,
                data_transform=dt, seed=(1, 2)), 1)
    out["chain_times"] = chain
    log(f"config 5 kernel times: {times}, chain {chain}")
    return out


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
    main_path["uncapturable_target"] = phase_uncapturable_target(device,
                                                                 N_CHAIN)
    maf_path = phase_maf_main_path(device, N_CHAIN, N_PIPELINE)
    hier = phase_hierarchical(device)
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
    ladders = {"nsf-tpu": main_path["ladders"],
               "nsf-tpu, split chain": main_path["ladders_split"],
               "maf-rqs": maf_path["ladders"],
               f"config 5 (n={N_HIER})": hier["ladders"]}
    for name, v in ladders.items():
        print(f"[{card}] {name} sample_posterior, device ladder (the default "
              f"path) vs host ladder in turns: {v['device_s']:.4f} s vs "
              f"{v['host_s']:.4f} s (medians of 3); capture "
              f"{v['capture_s']:.4f} s on its first call; {v['rungs']} "
              f"rungs, launches per device run {v['launches']}; log Z "
              f"{v['log_z']:.4f} +/- {v['log_z_err']:.4f} vs host "
              f"{v['host_log_z']:.4f} +/- {v['host_log_z_err']:.4f}",
              flush=True)
    for name, v in (("nsf-tpu", main_path["replay_vs_eager"]),
                    ("nsf-tpu, split chain",
                     main_path["replay_vs_eager_split"]),
                    ("maf-rqs", maf_path["replay_vs_eager"]),
                    (f"config 5 (n={N_HIER})", hier["replay_vs_eager"])):
        print(f"[{card}] {name}, graph replay vs eager rung (bit for bit, "
              f"and one replay's kernels on the card against its capture's "
              f"count): {v}", flush=True)
    from aspire_tpu_torch.flows.architectures import maf_rqs, nsf_tpu
    from aspire_tpu_torch.ops import fused_coupling as FC

    nsf4, maf4 = nsf_tpu(4), maf_rqs(4)
    b2_bound = chain_bound(nsf4, N_PIPELINE, CHAIN_STEPS)
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
    var, staged_bound = staged["variants"], staged["bound"]
    d2 = {"2": var["D1"], **{k[5:]: v for k, v in var.items()
                             if k.startswith("D2")}}
    for key, v in var.items():
        print(f"[{card}] {key}, staged coupling density pass, 4 layers, "
              f"n={N_COUPLING}: {v['ms']:.4f} ms events, "
              f"{v['kernel_ms']:.4f} ms alone (B1 in turns "
              f"{v['b1_ms']:.4f} ms; plain torch {v['plain_ms']:.4f} ms; "
              f"bound {staged_bound['bound_ms']:.4f} ms split TF32, all on "
              f"FP32 {staged_bound['bound_fp32_ms']:.4f} ms)")
    print(f"[{card}] uniforms kernel (D4), {uniforms['n']} draws: "
          f"{uniforms['ms']:.4f} ms (plain torch {uniforms['plain_ms']:.4f} "
          f"ms; torch.rand in turns {uniforms['library_ms']:.4f} ms; kernels "
          f"alone {uniforms['kernel_ms']:.4f} ms vs torch.rand's "
          f"{uniforms['library_kernel_ms']:.4f} ms; bound "
          f"{uniforms['bound_ms']:.4f} ms); probe (8, 256) seed "
          f"{PROBE_SEED}: {uniforms['probe']}", flush=True)
    wide = hierarchical_flow()
    ht, hc = hier["coupling_times"], hier["chain_times"]
    hb1 = coupling_bound(wide, N_HIER)
    hb2 = chain_bound(wide, N_HIER, HIER_STEPS)
    hier_err = max(v["max_abs_err"] for v in hier["coupling_checks"].values())
    print(f"[{card}] BASELINE config 5 (d=32 hierarchical, nsf 6 x (128, "
          f"128), 8 bins), n={N_HIER}, {HIER_STEPS}-step tpCN: SMC log Z "
          f"{hier['log_z']:.4f} +/- {hier['log_z_err']:.4f} in "
          f"{hier['n_temperatures']} temperatures; importance (262144) "
          f"{hier['log_z_importance']:.4f} +/- "
          f"{hier['log_z_importance_err']:.4f}; fit_s {hier['fit_s']:.2f}, "
          f"importance_s {hier['importance_s']:.2f}, smc_wall_s "
          f"{hier['smc_wall_s']:.2f}; quadrature truth "
          f"{hier['truth']['grid']:.4f} (dblquad "
          f"{hier['truth']['dblquad']:.5f}); reference TPU record "
          f"{HIER_TPU_RECORD[0]} +/- {HIER_TPU_RECORD[1]}", flush=True)
    r = hier["routes"]
    print(f"[{card}] config 5 routes at n={N_HIER_ROUTES}: whole chain "
          f"{r['fused_kernel']['log_z']:.4f} +/- "
          f"{r['fused_kernel']['log_z_err']:.4f}, split "
          f"{r['split']['log_z']:.4f} +/- {r['split']['log_z_err']:.4f} "
          f"(tolerance {hier['routes_tolerance']:.4f}); "
          f"{r['split']['launches']['coupling']} B1 launches in "
          f"{r['split']['n_mutations']} split mutations")
    print(f"[{card}] config 5 kernels, n={N_HIER}: B1 {ht['ms']:.4f} ms "
          f"events; B3 {ht['inverse_ms']:.4f} ms events (bound "
          f"{hb1['bound_ms']:.4f}); B2 {hc['ms']:.4f} ms events (bound "
          f"{hb2['bound_ms']:.4f}); at n={N_HIER_ROUTES}: B1 "
          f"{ht['ms_n131072']:.4f} ms vs plain torch {ht['plain_ms']:.4f}, "
          f"B2 {hc['ms_n131072']:.4f} vs plain torch {hc['plain_ms']:.4f}",
          flush=True)

    def hier_row(name, prefix, launches, b):
        return {"name": name, "route": "cuda",
                "config": "BASELINE config 5: d=32, nsf 6 x (128, 128), 8 "
                          "bins", "launches": launches,
                **{k: ht[prefix + k] for k in (
                    "ms", "ms_single_call", "plain_ms", "ms_n131072")},
                **b, "library_ms": None}

    kernels = [
        {"name": "coupling_kernel (B1 density / B3 sampling)",
         "route": "cuda", "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches": sum(main_path[k]["coupling"]
                         for k in ("launches", "split_launches")),
         "launches_fused_anchor": main_path["launches"]["coupling"],
         "launches_split_anchor": main_path["split_launches"]["coupling"],
         "launches_device_ladder_split": main_path["ladders_split"][
             "launches"]["coupling"],
         "launches_per_replay_profiled": main_path["replay_vs_eager_split"][
             "replay_kernels"]["coupling"],
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
         "launches_device_ladder": main_path["ladders"]["launches"]["chain"],
         "device_ladder_rungs": main_path["ladders"]["rungs"],
         "launches_per_replay_profiled": main_path["replay_vs_eager"][
             "replay_kernels"]["chain"],
         "max_abs_err": chain["max_abs_err"],
         "ms": chain_t["ms"], "ms_single_call": chain_t["ms_single_call"],
         "kernel_ms": chain_t["kernel_ms"],
         "plain_ms": chain_t["plain_ms"], **b2_bound, "library_ms": None},
        {"name": "maf_kernel (B4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/maf.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:598",
         "launches": maf_path["launches"]["maf"],
         "launches_device_ladder": maf_path["ladders"]["launches"]["maf"],
         "launches_per_replay_profiled": maf_path["replay_vs_eager"][
             "replay_kernels"]["maf"],
         "max_abs_err": maf["max_abs_err"],
         "ms": maf["ms"], "ms_single_call": maf["ms_single_call"],
         "kernel_ms": maf["kernel_ms"],
         f"kernel_ms_n{N_CHAIN}": maf[f"kernel_ms_n{N_CHAIN}"],
         "plain_ms": maf["plain_ms"], **b4_bound, "library_ms": None,
         f"ms_n{N_CHAIN}": maf[f"ms_n{N_CHAIN}"],
         f"ms_single_call_n{N_CHAIN}": maf[f"ms_single_call_n{N_CHAIN}"],
         f"bound_ms_n{N_CHAIN}": b4_bound_small["bound_ms"],
         "wrapper_ms": maf["wrapper_ms"]},
        {"name": "staged_mma_kernel interleaved (D1)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/interleave_ab.py:122",
         "launches": staged["launches"]["D1"],
         "max_abs_err": var["D1"]["max_abs_err"],
         "ms": var["D1"]["ms"], "ms_single_call": var["D1"]["ms_single_call"],
         "kernel_ms": var["D1"]["kernel_ms"],
         "plain_ms": var["D1"]["plain_ms"],
         **staged_bound, "bound_pipe": "split TF32",
         "library_ms": None, "b1_ms": var["D1"]["b1_ms"]},
        {"name": "staged_mma_kernel q (D2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/quad_interleave_ab.py:96",
         "launches": staged["launches"]["D2"],
         "max_abs_err": max(v["max_abs_err"] for v in d2.values()),
         "ms": var["D2 q=4"]["ms"],
         "ms_single_call": var["D2 q=4"]["ms_single_call"],
         "kernel_ms": var["D2 q=4"]["kernel_ms"],
         "plain_ms": var["D2 q=4"]["plain_ms"],
         **staged_bound, "bound_pipe": "split TF32",
         "library_ms": None,
         "kernel_ms_by_q": {q: v["kernel_ms"] for q, v in d2.items()},
         "ms_by_q": {q: v["ms"] for q, v in d2.items()},
         "plain_ms_by_q": {q: v["plain_ms"] for q, v in d2.items()},
         "b1_ms_by_q": {q: v["b1_ms"] for q, v in d2.items()}},
        {"name": "paired_kernel packed (D3)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/staged_coupling.cu",
         "replaces": "benchmarks/dev/packed_ab.py:147",
         "launches": staged["launches"]["D3"],
         "max_abs_err": max(var["D3"]["max_abs_err"],
                            var["D3 micro"]["max_abs_err"]),
         "ms": var["D3"]["ms"], "ms_single_call": var["D3"]["ms_single_call"],
         "kernel_ms": var["D3"]["kernel_ms"],
         "plain_ms": var["D3"]["plain_ms"],
         **staged_bound, "bound_pipe": "split TF32",
         "library_ms": None, "b1_ms": var["D3"]["b1_ms"],
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
        {**hier_row("coupling_kernel B1, config 5", "",
                    r["split"]["launches"]["coupling"], hb1),
         "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches_run": "split route at n=131072",
         "max_abs_err": hier_err},
        {**hier_row("coupling_kernel B3, config 5", "inverse_",
                    hier["launches"]["coupling"], hb1),
         "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches_run": "config 5 pipeline", "max_abs_err": hier_err},
        {"name": "chain_kernel B2, config 5", "route": "cuda",
         "config": "BASELINE config 5: d=32, nsf 6 x (128, 128), 8 bins, "
                   "hierarchical target, 32 steps",
         "source": "aspire_tpu_torch/csrc/chain.cu",
         "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
         "launches": hier["launches"]["chain"],
         "launches_run": "config 5 pipeline",
         "max_abs_err": hier["chain_check"]["max_abs_err"],
         **{k: hc[k] for k in ("ms", "ms_single_call", "plain_ms",
                               "ms_n131072")},
         **hb2, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# The modes that compare this checkout with the one at PARENT.
AB_MODES = {"--chain-ab": chain_ab, "--maf-ab": maf_ab,
            "--coupling-ab": coupling_ab, "--staged-ab": staged_ab,
            "--wide-ab": wide_ab}

if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in AB_MODES:
        print(card_line(), flush=True)
        print(json.dumps({sys.argv[1][2:].replace("-", "_"):
                          AB_MODES[sys.argv[1]](sys.argv[2])}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--accumulation":
        print(card_line(), flush=True)
        print(json.dumps({"accumulation": accumulation()}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--ladder-profile":
        print(card_line(), flush=True)
        print(json.dumps({"ladder_profile": ladder_profile()}), flush=True)
        sys.exit(0)
    sys.exit(main())
