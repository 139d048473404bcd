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
   forced); then runs with prior bounds (``phase_bounded_path``), B2
   running the data transform and the preconditioning as transform
   programs: the bounded 4-d Gaussian with a logit data transform (the
   anchor, every mutation on B2; the 131072 pipeline on the device ladder,
   one B2 launch and no B1 a rung, in turns with the host ladder, one
   population for both; ``replay_check``; the split route in turns), with
   a periodic parameter (a periodic preconditioning: the host ladder, B2
   with its program, against the split route in turns) and with a probit
   data transform (the anchor); B2 against the plain chain with each
   program (``PROGRAMS``, n = 8192 x 20 steps; config 5's wide B2 with the
   logit program at 16384 x 32), and B2 alone with each program in turns
   with the affine-only chain; then the JAX package's validation rows
   (``phase_validate_targets``): Rosenbrock at d = 2 (logit + affine data
   transform) and Neal's funnel at d = 5 (affine) with nsf-tpu fitted as
   ``benchmarks/validate.py`` fits it, B1/B3 at both shapes and B2 on each
   row against plain, Rosenbrock's anchor at n = 16384 against its
   quadrature truth, and the 131072 pipelines on both ladders and both
   routes; then the last single-device surface (``phase_replicated``):
   the funnel's anchor through ``Aspire.replicated_evidence`` (three flow
   refits, every mutation on B2, a device ladder captured for each
   replicate) against its quadrature truth, replicate 1's pipeline alone
   on a fresh ``Aspire`` (no stale graph or packing), a host likelihood
   over a ``spawn`` pool (``Aspire.enable_pool``; the host ladder, the
   split route on B1) bit for bit the run without it, and
   ``Aspire.get_sampler_class`` over the registry; then a user's own
   target (``phase_user_target``:
   ``PolynomialRegression``, its CUDA source built into an instance of
   B2 of its own, cold and then cached, a broken source refused; the
   instance's evaluation entry against the user's torch callables; B2
   against the plain chain on the callables at d = 4 and in the wide form
   at d = 32; the anchor against the analytic evidence; the 131072
   pipeline on both ladders and both routes; B2 on it in turns with B2
   on the mixture); then the gradient and ensemble SMC samplers
   (``phase_gradient_samplers``): the gradient of the flow density through
   the coupling and MAF kernels against the plain path's (nsf-tpu at d =
   2, 4, 5; maf-rqs), B2 with RWMH against the plain chain and in turns
   with B2's tpCN, the validation rows' samplers on the mixture (and RWMH
   and HMC on Rosenbrock and the funnel) against their truths at n =
   16384, BASELINE config 3 (NUTS on the funnel, 500 particles), and the
   131072 pipelines of RWMH, MALA, HMC and the stretch move on the device
   ladder in turns with the host ladder (one population, the launches a
   rung), MALA on maf-rqs (B4), NUTS on the host ladder;
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
   quadrature truth and the reference's TPU record; then the SMC options
   (``phase_smc_options``) and the mesh (``phase_mesh``): the mixture's
   131072 pipeline on the host ladder's split route in this process, the
   same run on NCCL at world size 1 (bit for bit) and on two gloo ranks on
   the one card, each with the ring, all-to-all and gathering resampling
   schedules, ranks as ``spawn`` children; the all-to-all's overflow; a
   data-parallel flow fit;
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
11. the flow-matching CNF (``phase_cnf``, plain torch, no kernel): its
   passes on the card against the CPU, ``benchmarks/validate.py``'s 8 CNF
   rows (importance and SMC on the Gaussian, the mixture, Rosenbrock and
   the funnel at n = 16384, the CNF fitted as the script fits it), and
   the mixture's 131072 pipeline on the device ladder in turns with the
   host ladder; SMC with ``preconditioning="flow"``
   (``phase_flow_preconditioning``: nsf-tpu inside, B3 in every chain
   step, and a CNF inside, on the mixture at n = 16384); the standalone
   samplers (``phase_mcmc``: minipcn's tpCN and pCN, emcee, and tpCN
   with a flow preconditioning, 16384 walkers on the bounded Gaussian,
   each dimension's moments against N(2, 1)); the parallel-tempered
   sampler (``phase_ptmcmc``: a float64 run on the card against the CPU
   under the same draws, ``benchmarks/validate.py``'s PT rows on the four
   targets at 512 walkers against their truths, the funnel on three fits
   combined, with the seconds and device operations a round; PT with a
   flow preconditioning, B3 in every half-move; SMC with
   ``n_replicates=3`` on the mixture); checkpoint and resume
   (``phase_checkpoint``: the mixture's 131072 pipeline on the device
   ladder with every rung's state handed over against none, the same bits,
   the middle state's bytes resumed on both ladders and the last state's,
   on the whole-chain and split routes; the HDF5 paths, which raise
   ``ImportError`` where h5py is missing; the cost of a checkpoint a rung);
12. print kernel and plain times, each kernel's bound, the kernels JSON
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
(``wide_ab``).
``--accumulation`` reads B2's flow density (on the d = 4
chain and on config 5's) and B4 against float64 over 20 draws each
(``accumulation``). ``--checkpoint`` runs ``phase_checkpoint`` alone
(``checkpoint_alone``), ``--replicated`` ``phase_replicated``
(``replicated_alone``), ``--mesh`` ``phase_mesh`` (``mesh_alone``). ``--ladder-profile`` profiles one warmed device-ladder
pipeline of nsf-tpu and of maf-rqs (``ladder_profile``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import subprocess
import sys
import time

N_COUPLING = 131072
N_CHAIN = 8192
N_PIPELINE = 131072
CHAIN_STEPS = 20
# The validation rows' SMC n (benchmarks/validate.py --n default).
N_VALIDATE = 16384
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
    # in a run of many traces), or without some of its launches (one of
    # five, once): trace again, at most twice more, until the kernels
    # recorded are a whole number per call.
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages() if match in e.key]
        us = sum(getattr(e, "device_time_total", 0) for e in found)
        count = sum(e.count for e in found)
        if us > 0 and count % reps == 0:
            return us / reps / 1e3
        log(f"the profiler recorded {count} kernels {match!r} for {reps} "
            f"calls (trace {attempt})")
    raise AssertionError(f"the profiler recorded no whole trace of "
                         f"{match!r}")


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


def captured_launches(ladder) -> dict:
    """The launches of B1/B3, B2 and B4 that ``ladder``'s capture counted
    (``ladder.captured``): what each replay of its graph adds."""
    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    counters = {"coupling": FC.launches, "chain": FM.launches,
                "maf": FC.maf_launches}
    made = _build.LaunchCounter.made
    return {k: ladder.captured[made.index(c)] for k, c in counters.items()}


def replay_kernels(ladder) -> dict:
    """The kernels one replay of ``ladder``'s graph runs on the card, per
    ``LADDER_KERNELS`` name, from ``torch.profiler``'s CUDA activity,
    against the launches its capture counted (``captured_launches``),
    which every replay adds to the wrapper counters: they must be equal."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counted = captured_launches(ladder)
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
    dt = FM.affine_program(torch.full((4,), 0.3, device=device),
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
    dt = FM.affine_program(z0.mean(dim=0), z0.std(dim=0))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    step0 = torch.full((n // FM.TILE,), 0.5, device=device)
    refs = (ref.mean, ref.chol, ref.inv_chol)
    return (cfg, params, z0, 0.7, step0, refs,
            problem.kernel_target(device), dt, gen)


#: The JAX package's validation rows (benchmarks/validate.py:299,309), each
#: with the nsf-tpu flow at its d: (problem name, d).
VALIDATE_ROWS = {"rosenbrock": ("rosenbrock", 2), "funnel": ("funnel", 5)}
#: the validation's other two targets, whose rows only ``phase_ptmcmc``
#: runs through ``validate_aspire``
PT_ONLY_ROWS = {"gaussian": ("gaussian", 4),
                "mixture": ("gaussian_mixture", 4)}


def validate_chain_setup(device, n: int, steps: int, row: str):
    """``program_chain_setup``'s tuple on a validation row (``VALIDATE_ROWS``):
    the problem's in-kernel target, nsf-tpu at its d perturbed by 0.1,
    start points from its initial draws (seed 3), the data transform
    ``Aspire`` gives it (logit + affine on Rosenbrock's prior bounds,
    affine for the unbounded funnel) fitted on them, lowered to programs,
    their Gaussian reference, tpCN at nu = 5 (nu + d = 7: gamma_m 3,
    gamma_odd 1; 10: 5, 0), beta 0.7, initial step 0.5, no
    preconditioning."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows.architectures import nsf_tpu
    from aspire_tpu_torch.models import get_problem
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.samplers import kernels as K
    from aspire_tpu_torch.transforms import FlowTransform

    name, d = VALIDATE_ROWS[row]
    problem = get_problem(name, dims=d)
    arch, params = perturbed_flow(device, 4, nsf_tpu(d), 0.1)
    k2 = 5 + d
    cfg = FM.ChainConfig(arch, "tpcn", steps, nu=5.0, gamma_m=k2 // 2,
                         gamma_odd=k2 % 2)
    z0 = torch.as_tensor(problem.draw_initial_samples(
        np.random.default_rng(3), n), dtype=torch.float32, device=device)
    transform = FlowTransform(parameters=problem.parameters,
                              prior_bounds=problem.prior_bounds,
                              bounded_transform="logit", dtype="float32",
                              device=device)
    transform.fit(z0)
    dt = FM.canonicalize_transform(transform, d)
    ref = K.fit_gaussian_reference(z0)
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    step0 = torch.full((n // FM.TILE,), 0.5, device=device)
    return (cfg, params, z0, 0.7, step0, (ref.mean, ref.chol, ref.inv_chol),
            problem.kernel_target(device), dt, gen, None)


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


#: the transform programs B2 is held to beside its affine data transform
#: (``bounded_programs``)
PROGRAMS = ("logit", "probit", "periodic", "affine_pc")


def bounded_programs(x, kind: str):
    """Start points and transform programs for B2 on the data-space points
    ``x`` (n, d), each dim bounded at 1.5 times the points' extent:
    ``(z0, dt, pc)``, z0 in the preconditioned space, pc None without
    preconditioning. ``kind`` (``PROGRAMS``): ``logit`` and ``probit``, the
    flow's data transform under prior bounds (the bounded map, then
    affine); ``periodic``, a periodic run's: the preconditioning a periodic
    wrap of dim 0, the data transform periodic on dim 0, logit on the
    others, then affine; ``affine_pc``, the logit data transform under an
    affine preconditioning (``preconditioning="standard"`` with
    ``affine_transform=True``)."""
    from aspire_tpu_torch import transforms as TT
    from aspire_tpu_torch.ops import fused_mutation as FM

    d = x.shape[1]
    names = [f"x_{i}" for i in range(d)]
    lo, hi = x.min(dim=0).values.tolist(), x.max(dim=0).values.tolist()
    bounds = {p: [0.5 * (a + b) - 0.75 * (b - a), 0.5 * (a + b)
                  + 0.75 * (b - a)] for p, a, b in zip(names, lo, hi)}
    kw = dict(parameters=names, prior_bounds=bounds, dtype=x.dtype,
              device=x.device)
    periodic = names[:1] if kind == "periodic" else []
    dt = TT.CompositeTransform(
        periodic_parameters=periodic,
        bounded_transform="probit" if kind == "probit" else "logit", **kw)
    dt.fit(x)
    pc = None
    if kind in ("periodic", "affine_pc"):
        pc = TT.CompositeTransform(periodic_parameters=periodic,
                                   bounded_to_unbounded=False,
                                   affine_transform=kind == "affine_pc", **kw)
    z0 = pc.fit(x) if pc is not None else x
    return (z0.contiguous(), FM.canonicalize_transform(dt, d),
            FM.canonicalize_transform(pc, d) if pc is not None else None)


def program_chain_setup(device, n: int, steps: int, kind: str,
                        setup=chain_setup):
    """``setup``'s chain with ``bounded_programs``'s ``kind`` in place of
    its affine data transform: its start points mapped to the
    preconditioned space, the reference fitted there. Returns ``setup``'s
    tuple with the preconditioning's program last."""
    from aspire_tpu_torch.samplers import kernels as K

    cfg, params, x0, beta, step0, _, target, _, gen = setup(device, n, steps)
    z0, dt, pc = bounded_programs(x0, kind)
    ref = K.fit_gaussian_reference(z0)
    return (cfg, params, z0, beta, step0, (ref.mean, ref.chol, ref.inv_chol),
            target, dt, gen, pc)


def assert_program_chain(setup: tuple, what: str) -> float:
    """B2 against the plain chain on ``setup`` (``program_chain_setup``'s
    tuple) on injected, nudged noise (``assert_chain_close``); the largest
    difference."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, step0, refs, target, dt, gen, pc = setup
    n, steps = z0.shape[0], cfg.n_steps
    noise = torch.rand((steps, cfg.noise_rows, n), generator=gen,
                       device=z0.device).clamp(1e-4, 1 - 1e-4)
    plain = FM.chain_plain(cfg, params, z0, beta, step0, *refs, target,
                           data_transform=dt, precond=pc, noise=noise,
                           return_acc_probs=True)
    nudge_accept_uniforms(noise, plain[-1])
    kern = FM.fused_mh_chain(cfg, params, z0, beta, None, step0, *refs,
                             target, data_transform=dt, precond=pc,
                             noise=noise)
    err = assert_chain_close(kern, plain)
    if not 0 < float(kern[4].sum()) < n * steps:
        raise AssertionError(f"{what}: every proposal accepted or none")
    return err


def check_chain_program(device, n: int, steps: int, kind: str,
                        setup=chain_setup) -> float:
    """``assert_program_chain`` with ``kind``'s programs."""
    return assert_program_chain(
        program_chain_setup(device, n, steps, kind, setup), kind)


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
    mean, std = dt.params

    def lq(p, x):
        xf = (x - mean.to(x)) / std.to(x)
        z, ld = arch.forward_plain(p, xf)
        return (-0.5 * torch.sum(z * z, dim=-1) - d * 0.5 * math.log(
            2 * math.pi) + ld - torch.sum(torch.log(torch.abs(std.to(x)))))

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
        if used:  # the entry's last line (device functions' lines follow)
            out[name]["registers"] = int(used[1])
            name = None
    return out


def wide_turn(draws: int) -> dict:
    """One turn of ``wide_ab``, in the checkout whose ``aspire_tpu_torch``
    the process imports: config 5's B1, B3 (weights packed once, through
    ``launch_packed``) and B2 (``hierarchical_chain_setup``'s chain,
    HIER_STEPS steps) at N_HIER and N_HIER_ROUTES, by events and single
    calls, then alone; their errors against float64 (B1/B3 over ``draws``
    input draws at N_HIER_CHECK, B2's lq over ``draws`` Philox seeds at
    N_CHAIN); the ptxas report of the wide kernels as this checkout's
    build logged it; and a digest of B2's outputs at N_HIER_ROUTES (beta
    0.7, seed (1, 2))."""
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
        if n == N_HIER_ROUTES:
            b2_digest = digest(chain())
        del x, z, z0
    accuracy = {"coupling": coupling_accuracy(
                    dev, N_HIER_CHECK, draws,
                    {"config 5": (hierarchical_flow(), 12, 0.05)}),
                "chain": chain_accuracy(dev, draws, N_CHAIN, HIER_STEPS,
                                        setup=hierarchical_chain_setup)}
    for key, run, match, reps in later:
        times[key]["kernel_ms"] = kernel_ms(run, match, reps)
    return {"times": times, "accuracy": accuracy, "ptxas": ptxas,
            "digest": b2_digest}


def wide_ab(parent: str, draws: int = 10) -> dict:
    """Config 5's wide kernels B1, B3 and B2 of the checkout at ``parent``
    against this one's, at N_HIER and N_HIER_ROUTES, in turns (parent,
    change, change, parent) on the same card, each turn a process of its
    own as in ``chain_ab`` (``wide_turn``): their times by events and
    alone, their errors against float64 on ``draws`` draws (the same in
    both turns of a checkout: the kernels are deterministic), each
    checkout's ptxas report of its wide kernels, and whether both
    checkouts' B2 outputs are the same bits (``digest``)."""
    out = path_ab(parent, "wide_turn", f"{draws}", "wide",
                  ("accuracy", "ptxas", "digest"))
    out["outputs_identical"] = (out["parent"]["digest"]
                                == out["change"]["digest"])
    return out


def ladder_turns(asp, run: dict, need: dict, truth: float | None = None,
                 warm: bool = True,
                 turns: tuple = ("device", "host", "host", "device",
                                 "device", "host")) -> dict:
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
    whether the two ladders give one population is reported, and per run
    (``per_run``) its ladder, rungs, B3 launches, evaluations and the range
    of its recorded taus.
    ``warm=False`` when the caller's own run was the device ladder's
    warm-up; ``turns``, fewer turns for a long run (the medians then of
    fewer walls)."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    runs = (["device", "host"] if warm else []) + list(turns)
    walls = {"device": [], "host": []}
    last, first, repeats = {}, {}, {"device": True, "host": True}
    per_run = []
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
        per_run.append({"ladder": ladder, "rungs": rungs,
                        "b3": FC.sampling_launches.count,
                        "evaluations": asp.sampler.n_likelihood_evaluations,
                        "tau_range": [min(hist.mcmc_autocorr),
                                      max(hist.mcmc_autocorr)]})
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
            check_result(post, run["n_samples"], truth, asp.dims)
    out = {"device_s": sorted(walls["device"])[len(walls["device"]) // 2],
           "host_s": sorted(walls["host"])[len(walls["host"]) // 2],
           "device_walls_s": walls["device"], "host_walls_s": walls["host"],
           "rungs": rungs, "host_rungs": host_rungs,
           "capture_s": last["capture_s"], "launches": last["launches"],
           "log_z": dpost.log_evidence, "log_z_err": dpost.log_evidence_error,
           "host_log_z": hpost.log_evidence,
           "host_log_z_err": hpost.log_evidence_error, "tolerance": tol,
           "runs_repeat": repeats, "per_run": per_run,
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


#: the fitted problems the phases share, by helper, device and arguments:
#: each is fitted once a run (no phase changes a fitted flow; a sampler is
#: made afresh at every ``sample_posterior``)
_FITTED: dict = {}


def fitted_once(fn):
    """``fn(device, ...)`` made once per distinct call, then shared."""
    @functools.wraps(fn)
    def shared(device, *args, **kw):
        key = (fn.__name__, str(device), repr(args), repr(sorted(kw.items())))
        if key not in _FITTED:
            _FITTED[key] = fn(device, *args, **kw)
        return _FITTED[key]
    return shared


@fitted_once
def bounded_aspire(device, **kw):
    """``GaussianProblem(dims=4)`` (N(2, 1) likelihood, U(-10, 10)^4
    prior, log Z = -4 ln 20) on its prior bounds, with an nsf-tpu flow
    fitted as ``phase_main_path`` fits its own: the flow's data transform
    is the bounded map (logit unless ``kw`` says otherwise), then affine.
    ``kw`` goes to ``Aspire``."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianProblem

    p = GaussianProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters,
                 prior_bounds=p.prior_bounds, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device, **kw)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    return p, asp


def program_ops(transform) -> list:
    """The op kinds of ``transform``'s program (``[]`` for none)."""
    from aspire_tpu_torch.ops import fused_mutation as FM

    prog = FM.canonicalize_transform(transform, 4)
    return [] if prog is None else [op for op, _ in prog.ops]


def bounded_anchor(p, asp, n: int, dt_ops: list, pc_ops: list) -> dict:
    """SMC at n on ``asp``'s default path: every mutation on B2, one launch
    each, with the data transform's and the preconditioning's programs
    ``dt_ops`` and ``pc_ops``; log Z against the truth (``check_result``)."""
    reset_launch_counts()
    samples = asp.sample_posterior(sampler="smc", n_samples=n,
                                   sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    launches = launch_counts()
    sampler = asp.sampler
    routes = sampler.history.mutation_route
    out = {"log_z": samples.log_evidence,
           "log_z_err": samples.log_evidence_error,
           "truth": p.true_log_evidence, "n_mutations": len(routes),
           "launches": launches,
           "dt_ops": program_ops(asp.flow.data_transform),
           "pc_ops": program_ops(sampler.preconditioning_transform)
           if sampler.preconditioning_transform is not None else [],
           "ladder": "device" if sampler.ladder is not None else "host"}
    log(f"bounded anchor, n={n}: {out}")
    if set(routes) != {"fused_kernel"}:
        raise AssertionError(f"mutations left the chain kernel: {routes}")
    if (out["dt_ops"], out["pc_ops"]) != (dt_ops, pc_ops):
        raise AssertionError(f"programs {out['dt_ops']}, {out['pc_ops']}; "
                             f"expected {dt_ops}, {pc_ops}")
    if asp.device.type == "cuda" and launches["chain"] != len(routes):
        raise AssertionError(f"{launches['chain']} B2 launches for "
                             f"{len(routes)} mutations")
    check_result(samples, n, p.true_log_evidence)
    return out


def route_turns(asp, run: dict) -> dict:
    """``run`` on its default ladder with the whole-chain kernel against
    ``fused_chain=False`` (the split chain), in turns (fused, split, split,
    fused, fused, split) after a warm-up of each: host clock to
    ``torch.cuda.synchronize()``, medians of 3; the routes each took, and
    the last runs' log Z within max(5 combined sigma, 0.15)."""
    import torch

    on_card = asp.device.type == "cuda"
    split_kwargs = dict(run["sampler_kwargs"], fused_chain=False)
    walls, last = {"fused_kernel": [], "split": []}, {}
    turns = ["fused_kernel", "split", "split", "fused_kernel",
             "fused_kernel", "split"]
    for i, route in enumerate(["fused_kernel", "split"] + turns):
        kw = dict(run, sampler_kwargs=split_kwargs) if route == "split" else run
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        post = asp.sample_posterior(**kw)
        if on_card:
            torch.cuda.synchronize()
        if i >= 2:
            walls[route].append(time.perf_counter() - t0)
        if set(asp.sampler.history.mutation_route) != {route}:
            raise AssertionError(f"a {route} run took "
                                 f"{set(asp.sampler.history.mutation_route)}")
        last[route] = post
    f, s = last["fused_kernel"], last["split"]
    tol = max(5 * math.hypot(f.log_evidence_error, s.log_evidence_error),
              0.15)
    out = {"fused_s": sorted(walls["fused_kernel"])[1],
           "split_s": sorted(walls["split"])[1], "walls_s": walls,
           "log_z": f.log_evidence, "log_z_err": f.log_evidence_error,
           "split_log_z": s.log_evidence,
           "split_log_z_err": s.log_evidence_error, "tolerance": tol,
           "ladder": "device" if asp.sampler.ladder is not None else "host"}
    log(f"routes in turns: {out}")
    if abs(f.log_evidence - s.log_evidence) >= tol:
        raise AssertionError(f"routes disagree on log Z: {out}")
    return out


def time_chain_programs(device, n: int, steps: int) -> dict:
    """B2 with each of ``PROGRAMS`` on ``chain_setup``'s flow and target
    (``program_chain_setup``) in turns with the same chain's affine-only
    B2 (affine, the programs, the programs reversed, affine): events
    (``cuda_ms``) per turn, the kernel alone noted for the end of the run
    (``kernel_ms_later``), and the plain chain with the logit program."""
    from aspire_tpu_torch.ops import fused_mutation as FM

    runs = {"affine": (*chain_setup(device, n, steps), None)}
    runs.update({kind: program_chain_setup(device, n, steps, kind)
                 for kind in PROGRAMS})

    def call(kind):
        cfg, params, z0, beta, step0, refs, target, dt, _, pc = runs[kind]
        return lambda: FM.fused_mh_chain(
            cfg, params, z0, beta, (1, 2), step0, *refs, target,
            data_transform=dt, precond=pc)

    out = {kind: {"ms": []} for kind in runs}
    for kind in ("affine", *PROGRAMS, *PROGRAMS[::-1], "affine"):
        out[kind]["ms"].append(cuda_ms(call(kind)))
    for kind in runs:
        kernel_ms_later(out[kind], "kernel_ms", call(kind), "chain_kernel",
                        reps=5)
    cfg, params, z0, beta, step0, refs, target, dt, _, pc = runs["logit"]
    out["logit"]["plain_ms"] = cuda_ms(lambda: FM.chain_plain(
        cfg, params, z0, beta, step0, *refs, target, data_transform=dt,
        precond=pc, seed=(1, 2)), reps=3)
    log(f"B2 with each program in turns with affine-only, n={n}: {out}")
    return out


def phase_bounded_path(device, n_anchor: int, n_pipeline: int) -> dict:
    """Runs with prior bounds, B2 running the transform programs:

    (a) the bounded Gaussian (``bounded_aspire``; a logit + affine data
    transform): the anchor at ``n_anchor`` (every mutation on B2); the
    ``n_pipeline`` pipeline on the default device ladder in turns with the
    host ladder (``ladder_turns``: one B2 launch a rung and no B1, one
    population for both ladders), ``replay_check``, and the split route
    (``fused_chain=False``, the route such runs took before B2 took
    programs) in turns the same way;
    (b) the same problem with a periodic parameter: a masked periodic
    preconditioning, so the host ladder, every mutation on B2 with its
    program; the anchor, and the pipeline against its split route;
    (c) the probit data transform: the anchor;
    (d) B2 against the plain chain with each of ``PROGRAMS`` at
    ``n_anchor`` x CHAIN_STEPS, and config 5's wide B2 with the logit
    program at N_HIER_CHECK x HIER_STEPS (injected, nudged noise);
    (e) B2 alone with each program (``time_chain_programs``).
    """
    from aspire_tpu_torch.ops import fused_mutation as FM

    on_card = device.type == "cuda"
    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    store_sample_history=False,
                    sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    p, asp = bounded_aspire(device)
    out = {"logit": {"anchor": bounded_anchor(p, asp, n_anchor,
                                              ["logit", "affine"], [])}}
    ladders = ladder_turns(asp, pipeline, {"chain": 1}, p.true_log_evidence)
    (_, lad), = asp.ladder_cache.values() if on_card else ((None, None),)
    per_rung = captured_launches(lad) if on_card else None
    log(f"bounded device ladder, launches a rung: {per_rung}")
    if on_card and (per_rung != {"coupling": 0, "chain": 1, "maf": 0}
                    or not ladders["ladders_agree_bitwise"]):
        raise AssertionError(f"bounded device ladder: {per_rung} a rung, "
                             f"{ladders}")
    out["logit"].update(ladders=ladders, per_rung=per_rung,
                        replay_vs_eager=replay_check(asp) if on_card
                        else None)
    split = dict(pipeline, sampler_kwargs=dict(n_steps=CHAIN_STEPS,
                                               fused_chain=False))
    out["logit"]["ladders_split"] = ladder_turns(
        asp, split, {"coupling": CHAIN_STEPS + 2}, p.true_log_evidence)

    p, asp = bounded_aspire(device, periodic_parameters=["x_0"])
    out["periodic"] = {
        "anchor": bounded_anchor(p, asp, n_anchor, ["logit", "affine"],
                                 ["periodic"]),
        "routes": route_turns(asp, pipeline)}
    if out["periodic"]["routes"]["ladder"] != "host":
        raise AssertionError("a preconditioned run took the device ladder")
    p, asp = bounded_aspire(device, bounded_transform="probit")
    out["probit"] = {"anchor": bounded_anchor(p, asp, n_anchor,
                                              ["probit", "affine"], [])}

    out["check_max_abs_err"] = {
        kind: check_chain_program(device, n_anchor, CHAIN_STEPS, kind)
        for kind in PROGRAMS}
    out["check_max_abs_err"]["wide logit"] = check_chain_program(
        device, N_HIER_CHECK, HIER_STEPS, "logit",
        setup=hierarchical_chain_setup)
    out["times"] = time_chain_programs(device, n_pipeline, CHAIN_STEPS)
    out["shared_bytes_d32"] = FM.chain_shared_bytes(
        hierarchical_flow(), FM.consts_layout(32)[-1])
    log(f"bounded path: {out}")
    return out


def rosenbrock_truth(lower: float = -5.0, upper: float = 5.0) -> float:
    """log Z of ``RosenbrockProblem(dims=2)``: ``benchmarks/validate.py::
    analytic_log_z``'s quadrature, copied (the likelihood summed on a
    6001 x 6001 grid over the box, by log-sum-exp), its grid taken 1000
    rows at a time."""
    import numpy as np
    from scipy.special import logsumexp as lse

    g = np.linspace(lower, upper, 6001)
    dx = g[1] - g[0]
    parts = []
    for i in range(0, g.size, 1000):
        X, Y = np.meshgrid(g[i:i + 1000], g, indexing="ij")
        parts.append(lse(-(100.0 * (Y - X**2) ** 2 + (1 - X) ** 2)))
    width = upper - lower
    return float(lse(parts) + 2 * np.log(dx) - 2 * np.log(width))


def funnel_truth(dims: int = 5, scale: float = 3.0,
                 prior_scale: float = 10.0) -> float:
    """log Z of ``FunnelProblem(dims)``: ``benchmarks/validate.py::
    analytic_log_z``'s quadrature, copied (the rest dims integrate out in
    closed form given v, leaving a 1-d sum over 400,001 points of v in
    [-60, 60])."""
    import numpy as np
    from scipy.special import logsumexp as lse

    s, d = prior_scale, dims - 1
    v = np.linspace(-60.0, 60.0, 400001)
    dv = v[1] - v[0]
    log_int = (
        -0.5 * v**2 / scale**2
        - 0.5 * np.log(2 * np.pi * scale**2)
        - 0.5 * v**2 / s**2
        - 0.5 * np.log(2 * np.pi * s**2)
        - 0.5 * d * np.log(2 * np.pi * (np.exp(v) + s**2))
    )
    return float(lse(log_int) + np.log(dv))


def combined_log_z(logzs, errs, label: str) -> tuple[float, float]:
    """The replicates' log Z and its error by the port's
    ``combine_replicates`` (the JAX package's rule: the mean; the
    between-run spread over sqrt(k) where it agrees with the single-run
    errors, the spread itself where it does not, at least their rms over
    sqrt(k))."""
    import types

    from aspire_tpu_torch.samplers.base import combine_replicates

    out = combine_replicates(types.SimpleNamespace(), list(logzs),
                             list(errs), label)
    return out.log_evidence, out.log_evidence_error


#: How ``benchmarks/validate.py`` fits a row's flow.
VALIDATE_FIT = {"n_epochs": 25, "batch_size": 512}


def validation_row(device, row: str, seed: int = 1):
    """A validation row as ``benchmarks/validate.py`` sets it up, not yet
    fitted: the problem (``VALIDATE_ROWS``, or ``PT_ONLY_ROWS``), an
    ``Aspire`` on its prior bounds with an nsf-tpu flow at the given seed,
    and its 8192 fit draws of ``default_rng(0)`` (the Gaussian's N(1,
    1.2), the others' own initial draws)."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import get_problem

    name, d = {**VALIDATE_ROWS, **PT_ONLY_ROWS}[row]
    p = get_problem(name, dims=d)
    rng = np.random.default_rng(0)
    init = Samples(rng.normal(1.0, 1.2, size=(8192, d)) if row == "gaussian"
                   else p.draw_initial_samples(rng, 8192))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=d, prior_bounds=p.prior_bounds, flow_backend="nsf",
                 architecture="nsf-tpu", seed=seed, device=device)
    return p, asp, init


@fitted_once
def validate_aspire(device, row: str, seed: int = 1):
    """A validation row as ``benchmarks/validate.py`` runs it
    (``validation_row``), its flow fitted as the script fits it
    (``VALIDATE_FIT``)."""
    p, asp, init = validation_row(device, row, seed)
    asp.fit(init, **VALIDATE_FIT)
    return p, asp


def validate_anchor(asp, n: int) -> dict:
    """SMC at n with 20-step tpCN on ``asp``'s default path: every mutation
    one B2 launch (counted), finite samples of the problem's shape."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC

    reset_launch_counts()
    post = asp.sample_posterior(sampler="smc", n_samples=n,
                                sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    launches = launch_counts()
    sampler = asp.sampler
    routes = sampler.history.mutation_route
    out = {"log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
           "n_mutations": len(routes), "launches": launches,
           "config": FC.config_id(asp.flow.architecture),
           "ladder": "device" if sampler.ladder is not None else "host"}
    if set(routes) != {"fused_kernel"}:
        raise AssertionError(f"mutations left the chain kernel: {routes}")
    if asp.device.type == "cuda" and (launches["chain"] != len(routes)
                                      or launches["coupling"] < 1):
        raise AssertionError(f"{launches} for {len(routes)} mutations")
    if tuple(post.x.shape) != (n, asp.dims) or not bool(
            torch.isfinite(post.x).all()) or not (
            math.isfinite(post.log_evidence)
            and math.isfinite(post.log_evidence_error)):
        raise AssertionError(f"anchor samples or log Z not finite: {out}")
    return out


def validate_kernels(device, row: str, n: int, n_chain: int,
                     n_pipeline: int) -> dict:
    """B1/B3 and B2 at a validation row's shape: B1/B3 of nsf-tpu at its d
    (perturbed by 0.1, seed 5) against plain at n under float64
    arbitration, and timed with plain torch beside; B2 on the row's
    chain (``validate_chain_setup``) against the plain chain at n_chain x
    CHAIN_STEPS, and timed at n_pipeline with plain torch beside."""
    import torch

    from aspire_tpu_torch.flows.architectures import nsf_tpu
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM

    _, d = VALIDATE_ROWS[row]
    c = coupling_outputs(device, (nsf_tpu(d), 5, 0.1), n, 1)
    bad = {what: assert_kernel_close(*v, f"{row} d={d} {what}")
           for what, v in c["outputs"].items()}
    out = {"d": d, "max_abs_err": max(
        max_err(k, p) for what, (k, p, _) in c["outputs"].items()
        if not what.startswith("round trip")),
        "ill_conditioned_points": bad}
    if device.type != "cuda":
        out["chain_max_abs_err"] = assert_program_chain(
            validate_chain_setup(device, n_chain, CHAIN_STEPS, row), row)
        return out
    arch, params, x, z = c["arch"], c["params"], c["x"], c["z"]
    coupling_times(arch, params, x, z, out)
    out["plain_ms"] = cuda_ms(lambda: arch.forward_plain(params, x), 5)
    out["inverse_plain_ms"] = cuda_ms(lambda: arch.inverse_plain(params, z),
                                      5)
    w = FC.prepare_mma_params(arch, params)
    for mode, key, inp in (("forward", "kernel_ms", x),
                           ("inverse", "inverse_kernel_ms", z)):
        kernel_ms_later(out, key, lambda mode=mode, inp=inp:
                        FC.launch_packed(arch, mode, w, inp),
                        "coupling_kernel")
    out["chain_max_abs_err"] = assert_program_chain(
        validate_chain_setup(device, n_chain, CHAIN_STEPS, row), row)
    cfg, cparams, z0, beta, step0, refs, target, dt, _, _ = (
        validate_chain_setup(device, n_pipeline, CHAIN_STEPS, row))

    def chain():
        return FM.fused_mh_chain(cfg, cparams, z0, beta, (1, 2), step0,
                                 *refs, target, data_transform=dt)

    out["chain_ms"] = cuda_ms(chain)
    out["chain_ms_single_call"] = cuda_ms_single(chain)
    out["chain_plain_ms"] = cuda_ms(lambda: FM.chain_plain(
        cfg, cparams, z0, beta, step0, *refs, target, data_transform=dt,
        seed=(1, 2)), 3)
    kernel_ms_later(out, "chain_kernel_ms", chain, "chain_kernel", reps=5)
    out["chain_program_level"] = FM.program_level(dt, None)
    torch.cuda.synchronize()
    return out


def phase_validate_targets(device, n_anchor: int, n_pipeline: int) -> dict:
    """The JAX package's validation rows (``benchmarks/validate.py``):
    Rosenbrock at d = 2 (logit + affine data transform on its box) and
    Neal's funnel at d = 5 (affine), each fitted as the script fits it
    (``validate_aspire``), nsf-tpu at B1/B3's and B2's configurations 3
    and 4:

    (a) B1/B3 at both shapes against plain at N_COUPLING, B2 on each row's
    chain against the plain chain at N_CHAIN x CHAIN_STEPS, and their
    times (``validate_kernels``);
    (b) Rosenbrock's anchor at ``n_anchor`` with 20-step tpCN, every
    mutation one B2 launch, its log Z within max(5 sigma, 0.02) of the
    quadrature truth (the funnel's anchor, gated on flow-refit replicates
    as the reference gates it, is ``phase_replicated``'s);
    (c) the ``n_pipeline`` pipelines: the device ladder in turns with the
    host ladder (1 B2 and 0 B1 a rung, one population for both),
    ``replay_check``, and the split route (B1, CHAIN_STEPS + 2 a rung) in
    turns the same way, the two routes' log Z within max(5 combined
    sigma, 0.15).
    """
    on_card = device.type == "cuda"
    out = {"truth": {"rosenbrock": rosenbrock_truth(),
                     "funnel": funnel_truth()}}
    log(f"validation rows' quadrature log Z: {out['truth']}")
    for row in VALIDATE_ROWS:
        out[row] = {"kernels": validate_kernels(
            device, row, N_COUPLING, N_CHAIN, n_pipeline)}
        log(f"{row}: kernels against plain: {out[row]['kernels']}")
    asps = {row: validate_aspire(device, row, 1)[1] for row in VALIDATE_ROWS}
    anchor = validate_anchor(asps["rosenbrock"], n_anchor)
    out["rosenbrock"]["anchor"] = {
        "log_z": anchor["log_z"], "log_z_err": anchor["log_z_err"],
        "runs": [anchor], "truth": out["truth"]["rosenbrock"]}
    log(f"rosenbrock anchor, n={n_anchor}: {out['rosenbrock']['anchor']}")
    # benchmarks/validate.py's gate.
    if not abs(anchor["log_z"] - out["truth"]["rosenbrock"]) < max(
            5 * anchor["log_z_err"], 0.02):
        raise AssertionError(f"rosenbrock anchor off the truth: "
                             f"{out['rosenbrock']['anchor']}")

    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    store_sample_history=False,
                    sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    split = dict(pipeline, sampler_kwargs=dict(n_steps=CHAIN_STEPS,
                                               fused_chain=False))
    for row, asp in asps.items():
        ladders = ladder_turns(asp, pipeline, {"chain": 1})
        (_, lad), = asp.ladder_cache.values() if on_card else ((None, None),)
        per_rung = captured_launches(lad) if on_card else None
        if on_card and (per_rung != {"coupling": 0, "chain": 1, "maf": 0}
                        or not ladders["ladders_agree_bitwise"]):
            raise AssertionError(f"{row} device ladder: {per_rung} a rung, "
                                 f"{ladders}")
        replay = replay_check(asp) if on_card else None
        ladders_split = ladder_turns(asp, split,
                                     {"coupling": CHAIN_STEPS + 2})
        tol = max(5 * math.hypot(ladders["log_z_err"],
                                 ladders_split["log_z_err"]), 0.15)
        if abs(ladders["log_z"] - ladders_split["log_z"]) >= tol:
            raise AssertionError(f"{row}: routes disagree on log Z: B2 "
                                 f"{ladders}, split {ladders_split}")
        out[row].update(ladders=ladders, per_rung=per_rung,
                        replay_vs_eager=replay, ladders_split=ladders_split,
                        routes_tolerance=tol)
        log(f"{row} pipelines, n={n_pipeline}: B2 {ladders}; split "
            f"{ladders_split}")
    return out


#: The funnel row's flow-refit replicates as ``benchmarks/validate.py``
#: asks for them (``replicated_evidence(3, refit_flow=True, ...)``).
REPLICATES = 3
#: ``phase_replicated``'s host pool: its workers, and the row chunks a
#: likelihood call maps over them.
POOL_WORKERS, POOL_CHUNKS = 4, 8


def mixture_rows_log_likelihood(x):
    """``GaussianMixtureProblem(dims)``'s log likelihood (its defaults:
    means +2 and -2 in every dim, variances 0.5 and 1) of the rows of the
    host array ``x``, in numpy and ``x``'s dtype: the function a host pool
    maps (at module level, so a ``spawn`` worker imports it)."""
    import numpy as np

    d = x.shape[-1]
    comps = [-0.5 * np.sum((x - mu) ** 2, axis=-1) / var
             - 0.5 * d * math.log(2 * math.pi * var)
             for mu, var in ((2.0, 0.5), (-2.0, 1.0))]
    return (np.logaddexp(*comps) - math.log(2.0)).astype(x.dtype, copy=False)


def pooled_mixture_log_likelihood(samples, map_fn=map):
    """The mixture's likelihood as a user of ``Aspire.enable_pool`` writes
    it: the rows to the host, ``mixture_rows_log_likelihood`` mapped over
    POOL_CHUNKS chunks of them with ``map_fn`` (``pool.map`` within the
    pool's block), the values handed back as numpy."""
    import numpy as np

    x = samples.x.detach().cpu().numpy()
    return np.concatenate(list(map_fn(mixture_rows_log_likelihood,
                                      np.array_split(x, POOL_CHUNKS))))


def replicated_funnel(device, n: int) -> dict:
    """``phase_replicated`` (a)-(c): a fresh funnel row (``validation_row``,
    fitted as ``validate_aspire`` fits it) through ``replicated_evidence(
    REPLICATES, refit_flow=True, fit_kwargs=VALIDATE_FIT)`` with SMC at n,
    20-step tpCN and no sample history, each replicate's run recorded
    (log Z, routes, B2 and B3 launches, whether its device ladder was
    captured in that run and in how many seconds, its weights); then the
    stale-graph check: a second fresh row whose flow is re-initialised at
    replicate 1's seed and fitted alike, run once."""
    import weakref

    import numpy as np
    import torch

    from aspire_tpu_torch.flows.train import param_leaves
    from aspire_tpu_torch.ops import fused_coupling as FC

    on_card = device.type == "cuda"
    truth = funnel_truth()
    run = dict(sampler="smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    _, asp, init = validation_row(device, "funnel", 1)
    asp.fit(init, **VALIDATE_FIT)
    flow = asp.flow
    runs, weights = [], []
    sample_posterior = asp.sample_posterior

    def recorded(**kw):
        """``asp.sample_posterior``, with what each replicate's run did."""
        earlier = [weakref.ref(v[1]) for v in asp.ladder_cache.values()]
        weights.append(torch.cat([t.detach().reshape(-1) for t in
                                  param_leaves(asp.flow.params)]).cpu())
        before, b3 = launch_counts(), FC.sampling_launches.count
        t0 = time.perf_counter()
        post = sample_posterior(**kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        routes = asp.sampler.history.mutation_route
        lad = asp.sampler.ladder
        runs.append({
            "log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
            "wall_s": wall, "routes": sorted(set(routes)),
            "n_mutations": len(routes),
            "launches": {k: v - before[k] for k, v in launch_counts().items()},
            "b3": FC.sampling_launches.count - b3,
            "config": FC.config_id(asp.flow.architecture),
            "ladder": "host" if lad is None else "device",
            "captured_here": lad is not None and lad.graph is not None
            and all(r() is not lad for r in earlier),
            "capture_s": None if lad is None else lad.capture_s})
        log(f"funnel replicate {len(runs)}: {runs[-1]}")
        return post

    asp.sample_posterior = recorded
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        post = asp.replicated_evidence(REPLICATES, refit_flow=True,
                                       fit_kwargs=dict(VALIDATE_FIT), **run)
    finally:
        del asp.sample_posterior
    out = {"n": n, "truth": truth, "log_z": post.log_evidence,
           "log_z_err": post.log_evidence_error,
           "replicates": np.asarray(post.log_evidence_replicates).tolist(),
           "single_run_err": post.log_evidence_error_single,
           "call_s": time.perf_counter() - t0, "runs": runs,
           "launches": launch_counts(),
           "last_routes": sorted(set(asp.sampler.history.mutation_route)),
           "same_flow_object": asp.flow is flow,
           "distinct_weights": all(
               not torch.equal(a, b) for i, a in enumerate(weights)
               for b in weights[i + 1:])}
    log(f"funnel replicated_evidence, n={n}: {out}")
    # benchmarks/validate.py's gate, on the combined log Z and error.
    if not abs(out["log_z"] - truth) < max(5 * out["log_z_err"], 0.02):
        raise AssertionError(f"funnel replicates off the truth: {out}")
    if (len(runs) != REPLICATES or out["replicates"] != [
            r["log_z"] for r in runs] or len(set(out["replicates"])) == 1
            or not out["same_flow_object"] or not out["distinct_weights"]
            or out["last_routes"] != ["fused_kernel"]
            or any(r["routes"] != ["fused_kernel"] for r in runs)):
        raise AssertionError(f"funnel replicates: {out}")
    if on_card and (
            out["launches"]["chain"] != sum(r["n_mutations"] for r in runs)
            or any(r["launches"]["chain"] != r["n_mutations"] or r["b3"] < 1
                   or not r["captured_here"] for r in runs)):
        raise AssertionError(f"funnel replicates' kernels: {out}")

    # (c) No stale graph or packing: replicate 1's pipeline alone.
    _, again, init = validation_row(device, "funnel", 1)
    again.init_flow()
    again.flow.reinitialize(1 + 101 + 0)
    again.fit(init, **VALIDATE_FIT)
    same = torch.equal(torch.cat([t.detach().reshape(-1) for t in
                                  param_leaves(again.flow.params)]).cpu(),
                       weights[0])
    solo = again.sample_posterior(**run)
    first = runs[0]
    tol = max(5 * math.hypot(first["log_z_err"], solo.log_evidence_error),
              0.15)
    out["stale_check"] = {
        "weights_bit_identical": same, "log_z": solo.log_evidence,
        "log_z_err": solo.log_evidence_error,
        "replicate_1_log_z": first["log_z"],
        "log_z_bit_identical": solo.log_evidence == first["log_z"],
        "tolerance": tol}
    log(f"funnel replicate 1 alone: {out['stale_check']}")
    if (same and solo.log_evidence != first["log_z"]) or (
            abs(solo.log_evidence - first["log_z"]) >= tol):
        raise AssertionError(f"replicate 1 alone: {out['stale_check']}")
    out["anchor"] = {"log_z": out["log_z"], "log_z_err": out["log_z_err"],
                     "runs": runs, "truth": truth}
    return out


def pooled_likelihood(device, n: int) -> dict:
    """``phase_replicated`` (d): ``GaussianMixtureProblem(dims=4)`` with the
    main path's nsf-tpu fit (as ``phase_uncapturable_target`` fits it) and
    ``pooled_mixture_log_likelihood``, SMC at n with 20-step tpCN and no
    sample history, with ``map_fn=map`` and then within
    ``asp.enable_pool`` over a ``spawn`` pool of POOL_WORKERS: each run on
    the host ladder (the likelihood hands back numpy, so it cannot be
    captured) and the split route, B1 on every density pass and B3 on the
    draw; the same log Z bit for bit, in the anchor's gate; the pool
    closed and the likelihood restored on exit."""
    import multiprocessing

    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, PoolHandler, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem
    from aspire_tpu_torch.ops import fused_coupling as FC

    on_card = device.type == "cuda"
    p = GaussianMixtureProblem(dims=4)
    x = torch.as_tensor(p.draw_initial_samples(np.random.default_rng(1),
                                               1000), dtype=torch.float32)
    numpy_err = max_err(torch.as_tensor(mixture_rows_log_likelihood(
        x.numpy())), p.log_likelihood(Samples(x)))
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=pooled_mixture_log_likelihood,
                 log_prior=p.log_prior, dims=4, parameters=p.parameters,
                 flow_backend="nsf", architecture="nsf-tpu", seed=1,
                 device=device)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    run = dict(sampler="smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))

    def timed_run():
        reset_launch_counts()
        t0 = time.perf_counter()
        post = asp.sample_posterior(**run)
        if on_card:
            torch.cuda.synchronize()
        sampler = asp.sampler
        routes = sampler.history.mutation_route
        b3 = FC.sampling_launches.count
        return post, {
            "wall_s": time.perf_counter() - t0, "log_z": post.log_evidence,
            "log_z_err": post.log_evidence_error,
            "ladder": "host" if sampler.ladder is None else "device",
            "capturable": sampler.target_is_capturable(),
            "routes": sorted(set(routes)), "n_mutations": len(routes),
            "b1": launch_counts()["coupling"] - b3, "b3": b3}

    plain_post, plain = timed_run()
    pool = multiprocessing.get_context("spawn").Pool(POOL_WORKERS)
    with asp.enable_pool(pool) as handler:
        is_handler = isinstance(handler, PoolHandler)
        swapped = asp.log_likelihood is not pooled_mixture_log_likelihood
        pooled_post, pooled = timed_run()
    try:
        pool.map(mixture_rows_log_likelihood, [x.numpy()])
        closed = False
    except ValueError:
        closed = True
    out = {"n": n, "map": plain, "pool": pooled, "workers": POOL_WORKERS,
           "chunks": POOL_CHUNKS, "numpy_max_abs_err": numpy_err,
           "truth": p.true_log_evidence(),
           "log_z_bit_identical": pooled["log_z"] == plain["log_z"]
           and torch.equal(pooled_post.x, plain_post.x),
           "handler": is_handler and swapped, "pool_closed": closed,
           "restored": asp.log_likelihood is pooled_mixture_log_likelihood}
    log(f"pooled host likelihood, n={n}: {out}")
    for name, r in (("map", plain), ("pool", pooled)):
        if (r["ladder"], r["capturable"], r["routes"]) != (
                "host", False, ["split"]) or (on_card and (
                r["b1"] < (CHAIN_STEPS + 2) * r["n_mutations"]
                or r["b3"] < 1)):
            raise AssertionError(f"the {name} run of the pooled likelihood: "
                                 f"{r}")
    if not (out["log_z_bit_identical"] and out["handler"]
            and out["pool_closed"] and out["restored"]
            and numpy_err < 1e-4):
        raise AssertionError(f"pooled host likelihood: {out}")
    check_result(pooled_post, n, out["truth"])
    return out


def phase_replicated(device, n: int, n_pool: int) -> dict:
    """The last single-device surface of the port:

    (a) the funnel row through the port's ``Aspire.replicated_evidence``
    at ``n`` (``replicated_funnel``), gated as ``benchmarks/validate.py``
    gates it: |log Z - ``funnel_truth()``| < max(5 sigma, 0.02) on the
    combination;
    (b) every replicate on the card's kernels with its own weights: each
    mutation one B2 launch (counted over the call), B3 for each
    replicate's initial draws, a device ladder captured in each
    replicate's run (its seconds), distinct log Z;
    (c) no stale graph or packing: replicate 1's pipeline on a fresh
    ``Aspire``, bit for bit where its fitted weights are, else within
    max(5 combined sigma, 0.15);
    (d) a host likelihood over a ``spawn`` pool (``pooled_likelihood``) at
    ``n_pool``, bit for bit the run without the pool;
    (e) ``Aspire.get_sampler_class`` for every key of the registry.
    """
    from aspire_tpu_torch import Aspire
    from aspire_tpu_torch.samplers import SAMPLER_REGISTRY

    out = {"funnel": replicated_funnel(device, n),
           "pool": pooled_likelihood(device, n_pool)}
    asp = Aspire(log_likelihood=None, log_prior=None, dims=2, device=device)
    classes = {k: asp.get_sampler_class(k) is v
               for k, v in SAMPLER_REGISTRY.items()}
    out["registry"] = {"keys": len(classes), "all_match": all(
        classes.values())}
    if out["registry"] != {"keys": 18, "all_match": True}:
        raise AssertionError(f"the sampler registry: {classes}")
    return out


def report_replicated(card: str, rep: dict, phase_s: float) -> None:
    """Print ``phase_replicated``'s results and its seconds, a line each."""
    f, c, pool = rep["funnel"], rep["funnel"]["stale_check"], rep["pool"]
    per_replicate = "; ".join(
        f"{r['n_mutations']} mutations, B2 {r['launches']['chain']}, B3 "
        f"{r['b3']}, "
        f"{r['ladder']} ladder captured in {r['capture_s']} s, run "
        f"{r['wall_s']:.3f} s" for r in f["runs"])
    print(f"[{card}] funnel replicated_evidence({REPLICATES}, refit_flow="
          f"True), n={f['n']}: log Z {f['log_z']:.4f} +/- "
          f"{f['log_z_err']:.4f} vs quadrature {f['truth']:.4f} (replicates "
          f"{', '.join(f'{v:.4f}' for v in f['replicates'])}; single-run "
          f"rms {f['single_run_err']:.4f}); call {f['call_s']:.1f} s; per "
          f"replicate: {per_replicate}", flush=True)
    print(f"[{card}] funnel replicate 1 alone (reinitialize({1 + 101}), "
          f"fit, SMC): weights bit-identical {c['weights_bit_identical']}, "
          f"log Z {c['log_z']:.6f} vs {c['replicate_1_log_z']:.6f} "
          f"(bit-identical {c['log_z_bit_identical']}, tolerance "
          f"{c['tolerance']:.4f})", flush=True)
    m, p = pool["map"], pool["pool"]
    print(f"[{card}] pooled host likelihood (mixture d=4, nsf-tpu, "
          f"n={pool['n']}, {pool['workers']} spawn workers x "
          f"{pool['chunks']} chunks): map_fn=map {m['wall_s']:.3f} s, pool "
          f"{p['wall_s']:.3f} s; log Z {p['log_z']:.4f} +/- "
          f"{p['log_z_err']:.4f} vs analytic {pool['truth']:.4f}, bit-"
          f"identical {pool['log_z_bit_identical']}; {p['ladder']} ladder, "
          f"{p['routes']} route, B1 {p['b1']} in {p['n_mutations']} "
          f"mutations, B3 {p['b3']}", flush=True)
    print(f"[{card}] phase_replicated: {phase_s:.1f} s (registry "
          f"{rep['registry']['keys']} keys)", flush=True)


def replicated_alone() -> dict:
    """``phase_replicated`` alone after the kernels' build, its lines
    printed; its seconds and each part's numbers."""
    import torch

    from aspire_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    device = torch.device("cuda")
    t0 = time.perf_counter()
    rep = phase_replicated(device, N_VALIDATE, N_CHAIN)
    phase_s = time.perf_counter() - t0
    report_replicated(card_line(), rep, phase_s)
    f = rep["funnel"]
    return {"phase_s": phase_s, "log_z": f["log_z"],
            "log_z_err": f["log_z_err"], "replicates": f["replicates"],
            "capture_s": [r["capture_s"] for r in f["runs"]],
            "stale_check": f["stale_check"],
            "pool_s": rep["pool"]["pool"]["wall_s"],
            "map_s": rep["pool"]["map"]["wall_s"]}


#: A user's own target on B2 (``models/targets.py``'s protocol): Bayesian
#: polynomial regression on REGRESSION_POINTS evenly spaced t in [-1, 1],
#: noise sigma REGRESSION_SIGMA.
REGRESSION_POINTS, REGRESSION_SIGMA = 128, 0.3

#: ``PolynomialRegression``'s target as CUDA source: the constants are
#: (t, y, sigma); the mean at t by Horner's rule on the coefficients x.
REGRESSION_CUDA = r"""
template <int D, class X>
__device__ void user_target(const float* c, const X& x, float& lpi,
                            float& ll) {
  constexpr int M = 128;
  constexpr float kHalfLog2Pi = 0.918938533204672742f;
  const float sigma = c[2 * M];
  float q = 0.f;
  for (int j = 0; j < M; ++j) {
    const float t = c[j];
    float m = x[D - 1];
#pragma unroll
    for (int k = D - 2; k >= 0; --k) m = m * t + x[k];
    const float r = (c[M + j] - m) / sigma;
    q += r * r;
  }
  ll = -0.5f * q - M * (kHalfLog2Pi + logf(sigma));
  float p = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) p += x[i] * x[i];
  lpi = -0.5f * p - D * kHalfLog2Pi;
}
"""


class PolynomialRegression:
    """A user's Bayesian polynomial regression, written as a user of the
    port would write it: D coefficients theta of the basis t^k (k = 0..D-1)
    on REGRESSION_POINTS evenly spaced t in [-1, 1]; data y = Phi theta* +
    sigma eps, sigma = REGRESSION_SIGMA, theta* and eps from
    ``np.random.default_rng(seed)``; prior theta ~ N(0, I). Its torch
    ``log_likelihood``/``log_prior`` are the plain version of its CUDA
    source (``REGRESSION_CUDA``), which ``kernel_target`` hands to the
    chain kernel. The log-evidence is analytic (``true_log_evidence``);
    the "existing samples" are the analytic posterior's draws shifted by
    0.5 of its standard deviation in every coefficient and widened 1.5x
    (a shift of 0.5 in the coefficients' own units is 3-13 posterior
    standard deviations: the flow fitted on such draws misses the
    posterior, and SMC's log Z on the whole-chain route, the plain chain
    on the CPU, then sat 0.56 below the truth at n = 8192, 11 sigma)."""

    def __init__(self, dims: int = 4, seed: int = 0):
        import numpy as np

        rng = np.random.default_rng(seed)
        self.dims = dims
        self.parameters = [f"theta_{k}" for k in range(dims)]
        self.t = np.linspace(-1.0, 1.0, REGRESSION_POINTS)
        self.phi = self.t[:, None] ** np.arange(dims)
        self.theta_star = rng.normal(size=dims)
        self.y = (self.phi @ self.theta_star
                  + REGRESSION_SIGMA * rng.normal(size=REGRESSION_POINTS))
        self._data = {}

    def _on(self, x):
        """(t, y) as tensors on x's device and dtype, made once each."""
        import torch

        key = (x.device, x.dtype)
        if key not in self._data:
            self._data[key] = tuple(torch.as_tensor(v, dtype=x.dtype,
                                                    device=x.device)
                                    for v in (self.t, self.y))
        return self._data[key]

    def log_likelihood(self, samples):
        x = samples.x
        t, y = self._on(x)
        m = x[:, -1:].expand(-1, t.numel())
        for k in range(self.dims - 2, -1, -1):
            m = m * t + x[:, k:k + 1]
        r = (y - m) / REGRESSION_SIGMA
        return (-0.5 * (r * r).sum(dim=-1) - REGRESSION_POINTS
                * (0.5 * math.log(2 * math.pi) + math.log(REGRESSION_SIGMA)))

    def log_prior(self, samples):
        x = samples.x
        return (-0.5 * (x * x).sum(dim=-1)
                - self.dims * 0.5 * math.log(2 * math.pi))

    def kernel_target(self, device="cpu"):
        from aspire_tpu_torch.models import KernelSource, kernel_constants

        return (KernelSource("polynomial_regression", REGRESSION_CUDA),
                kernel_constants(self, [*self.t, *self.y, REGRESSION_SIGMA],
                                 device))

    def posterior(self):
        """The analytic posterior's mean and covariance (float64)."""
        import numpy as np

        prec = np.eye(self.dims) + self.phi.T @ self.phi / REGRESSION_SIGMA**2
        cov = np.linalg.inv(prec)
        return cov @ self.phi.T @ self.y / REGRESSION_SIGMA**2, cov

    def true_log_evidence(self) -> float:
        """log N(y; 0, sigma^2 I + Phi Phi^T), in float64."""
        import numpy as np

        cov = (REGRESSION_SIGMA**2 * np.eye(REGRESSION_POINTS)
               + self.phi @ self.phi.T)
        _, logdet = np.linalg.slogdet(cov)
        return float(-0.5 * (self.y @ np.linalg.solve(cov, self.y) + logdet
                             + REGRESSION_POINTS * math.log(2 * math.pi)))

    def posterior_draws(self, rng, n: int, shift: float = 0.0,
                        widen: float = 1.0):
        """n draws of the analytic posterior, shifted by ``shift`` of its
        standard deviation in every coefficient and widened
        ``widen``-fold about its mean."""
        import numpy as np

        mean, cov = self.posterior()
        return rng.multivariate_normal(mean + shift * np.sqrt(np.diag(cov)),
                                       widen**2 * cov, size=n)

    def draw_initial_samples(self, rng, n: int):
        return self.posterior_draws(rng, n, shift=0.5, widen=1.5)


def user_target_of(problem, device):
    """``problem``'s chain target as the sampler makes it from its
    ``kernel_target``: ``(UserTarget, constants)``, the plain version the
    problem's own callables."""
    import types

    from aspire_tpu_torch.ops import fused_mutation as FM

    source, consts = problem.kernel_target(device)

    def plain(x):
        view = types.SimpleNamespace(x=x)
        return problem.log_prior(view), problem.log_likelihood(view)

    return FM.UserTarget(source, plain), consts


def regression_chain_setup(device, n: int, steps: int, dims: int = 4,
                           arch=None, scale: float = 0.1):
    """``program_chain_setup``'s tuple on ``PolynomialRegression(dims)``:
    ``arch`` (nsf-tpu at dims) perturbed by ``scale``, start points the
    analytic posterior's draws widened 1.5x (seed 3), their affine data
    transform and Gaussian reference, tpCN at nu = 5 (gamma_m, gamma_odd
    from nu + d), beta 0.7, initial step 0.5, no preconditioning."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows.architectures import nsf_tpu
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.samplers import kernels as K

    problem = PolynomialRegression(dims)
    arch, params = perturbed_flow(device, 6, arch or nsf_tpu(dims), scale)
    k2 = 5 + dims
    cfg = FM.ChainConfig(arch, "tpcn", steps, nu=5.0, gamma_m=k2 // 2,
                         gamma_odd=k2 % 2)
    z0 = torch.as_tensor(problem.posterior_draws(
        np.random.default_rng(3), n, widen=1.5), dtype=torch.float32,
        device=device)
    ref = K.fit_gaussian_reference(z0)
    dt = FM.affine_program(z0.mean(dim=0), z0.std(dim=0))
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    step0 = torch.full((n // FM.TILE,), 0.5, device=device)
    return (cfg, params, z0, 0.7, step0, (ref.mean, ref.chol, ref.inv_chol),
            user_target_of(problem, device), dt, gen, None)


def regression_aspire(device):
    """``PolynomialRegression()`` with the main path's nsf-tpu flow fitted
    as ``phase_main_path`` fits it: 20 epochs at batch 512 on 4000 of its
    existing samples (``default_rng(42)``)."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples

    p = PolynomialRegression()
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=p.dims, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    return p, asp


#: A source the user target's build must refuse.
BROKEN_CUDA = REGRESSION_CUDA.replace("q += r * r;", "q += r * r")


def user_target_build(device) -> dict:
    """The regression's instance at configuration 0, built cold (any cached
    build removed first) and then found in the cache, with both times; a
    source with a syntax error must raise ``RuntimeError`` with nvcc's
    message."""
    from aspire_tpu_torch.models import KernelSource
    from aspire_tpu_torch.ops import _build

    source = PolynomialRegression().kernel_target(device)[0]
    path = _build.user_library_path(source, 0)
    path.unlink(missing_ok=True)
    t0 = time.perf_counter()
    _build.build_user(source, 0)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    _build.load_user_library(source, 0)
    cached = time.perf_counter() - t0
    ptxas = [line.strip() for line in path.with_suffix(".log").read_text()
             .splitlines() if "registers" in line or "spill" in line]
    broken = KernelSource("polynomial_regression_broken", BROKEN_CUDA)
    _build.user_library_path(broken, 0).unlink(missing_ok=True)
    try:
        _build.build_user(broken, 0)
        refused = None
    except RuntimeError as err:
        refused = str(err).splitlines()[0]
    out = {"cold_s": cold, "cached_s": cached, "ptxas": ptxas,
           "broken_source": refused}
    log(f"user target build: {out}")
    if refused is None or "nvcc failed" not in refused:
        raise AssertionError("a user source with a syntax error built")
    return out


def user_target_eval_check(device, n: int) -> dict:
    """The instance's evaluation entry (``FM.user_target_eval``) against
    the user's torch callables at n points (the analytic posterior widened
    2x, seed 5), float64 deciding: each of log_prior and log_likelihood
    within 1e-5 relative or 2e-3 absolute of float32's; and their times."""
    import numpy as np
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    p = PolynomialRegression()
    target, consts = user_target_of(p, device)
    x = torch.as_tensor(p.posterior_draws(np.random.default_rng(5), n,
                                          widen=2.0), dtype=torch.float32,
                        device=device)
    FM.user_target_launches.reset()
    kern = FM.user_target_eval(target, consts, 0, x)
    launches = FM.user_target_launches.count
    plain = target.plain(x)
    exact = target.plain(x.double())
    out = {"n": n, "launches": launches}
    if device.type == "cuda" and launches != 1:
        raise AssertionError(f"the evaluation entry launched {launches} times")
    for name, k, q, e in zip(("log_prior", "log_likelihood"), kern, plain,
                             exact):
        err = (k.double() - e).abs()
        tol = 2e-3 + 1e-5 * e.abs()
        out[f"{name}_max_abs_err"] = max_err(k, q)
        out[f"{name}_max_err_f64"] = float(err.max())
        if not bool((err <= tol).all()):
            raise AssertionError(f"user target {name}: {int((err > tol).sum())}"
                                 f" points beyond 2e-3 + 1e-5 |f64|")
    if device.type == "cuda":
        out["ms"] = cuda_ms(lambda: FM.user_target_eval(target, consts, 0, x))
        out["plain_ms"] = cuda_ms(lambda: target.plain(x))
    log(f"user target evaluation against its torch callables: {out}")
    return out


def user_chain_check(device, wide: bool) -> float:
    """B2 on the regression against the plain chain on the user's
    callables (``assert_program_chain``): nsf-tpu at d = 4, N_CHAIN x
    CHAIN_STEPS; or (``wide``) config 5's flow shape at d = 32, one tile x
    CHAIN_STEPS (``chain_kernel_wide``, the target reading a Strided
    view); then, on the card, its Philox stream against the same stream
    injected, bit for bit."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    setup = (regression_chain_setup(device, FM.TILE, CHAIN_STEPS, 32,
                                    hierarchical_flow(), 0.05)
             if wide else regression_chain_setup(device, N_CHAIN,
                                                 CHAIN_STEPS))
    err = assert_program_chain(setup, "user target" + " wide" * wide)
    cfg, params, z0, beta, step0, refs, target, dt, _, _ = setup
    seed = (0x12345678, 0x9ABCDEF0)
    drawn = FM.fused_mh_chain(cfg, params, z0, beta, seed, step0, *refs,
                              target, data_transform=dt)
    injected = torch.stack([
        FM.philox_uniforms(seed, t, cfg.noise_rows, z0.shape[0], device)
        for t in range(cfg.n_steps)])
    replay = FM.fused_mh_chain(cfg, params, z0, beta, None, step0, *refs,
                               target, data_transform=dt, noise=injected)
    if not all(torch.equal(a, b) for a, b in zip(drawn, replay)):
        raise AssertionError("user target: in-kernel Philox differs from "
                             "the replay")
    return err


def user_chain_times(device, n: int) -> dict:
    """B2 on the regression at n x CHAIN_STEPS in turns with B2 on the
    built-in mixture (``chain_setup``; mixture, user, user, mixture),
    events, the kernels alone noted for the end of the run, and the plain
    chain on the user's callables."""
    from aspire_tpu_torch.ops import fused_mutation as FM

    runs = {"mixture": (*chain_setup(device, n, CHAIN_STEPS), None),
            "user": regression_chain_setup(device, n, CHAIN_STEPS)}

    def call(kind):
        cfg, params, z0, beta, step0, refs, target, dt, _, pc = runs[kind]
        return lambda: FM.fused_mh_chain(cfg, params, z0, beta, (1, 2),
                                         step0, *refs, target,
                                         data_transform=dt, precond=pc)

    out = {kind: {"ms": []} for kind in runs}
    for kind in ("mixture", "user", "user", "mixture"):
        out[kind]["ms"].append(cuda_ms(call(kind)))
    out["user"]["ms_single_call"] = cuda_ms_single(call("user"))
    for kind in runs:
        kernel_ms_later(out[kind], "kernel_ms", call(kind), "chain_kernel",
                        reps=5)
    cfg, params, z0, beta, step0, refs, target, dt, _, _ = runs["user"]
    out["user"]["plain_ms"] = cuda_ms(lambda: FM.chain_plain(
        cfg, params, z0, beta, step0, *refs, target, data_transform=dt,
        seed=(1, 2)), reps=3)
    log(f"B2 on the user target in turns with the mixture, n={n}: {out}")
    return out


def phase_user_target(device, n_anchor: int, n_pipeline: int) -> dict:
    """A user's own target on B2 (``PolynomialRegression``, its CUDA source
    built into an instance of B2 of its own):

    (a) the build: cold, then cached, with both times and the ptxas line;
    a source with a syntax error raises (``user_target_build``);
    (b) the instance's evaluation entry against the user's torch
    callables at ``n_pipeline`` points (``user_target_eval_check``);
    (c) B2 against the plain chain on the callables at d = 4 and, in the
    wide form, at d = 32, the Philox stream against its replay bit for bit
    (``user_chain_check``);
    (d) the main path's flow and sizes: nsf-tpu fitted on the existing
    samples; the anchor at ``n_anchor`` (every mutation one B2 launch, log
    Z against the analytic evidence); the ``n_pipeline`` pipeline on the
    device ladder in turns with the host ladder (1 B2 and 0 B1 a rung, one
    population for both, ``replay_check``) and the split route (B1 and the
    callables, ``fused_chain=False``) in turns the same way, every run's
    log Z against the analytic evidence;
    (e) B2 alone on the regression in turns with B2 on the mixture
    (``user_chain_times``)."""
    on_card = device.type == "cuda"
    out = {"build": user_target_build(device) if on_card else None,
           "eval": user_target_eval_check(device, n_pipeline)}
    out["chain_max_abs_err"] = user_chain_check(device, wide=False)
    out["wide_chain_max_abs_err"] = user_chain_check(device, wide=True)
    log(f"user target chains against plain: d=4 {out['chain_max_abs_err']},"
        f" d=32 {out['wide_chain_max_abs_err']}")
    p, asp = regression_aspire(device)
    truth = p.true_log_evidence()
    out["truth"] = truth
    reset_launch_counts()
    post = asp.sample_posterior(sampler="smc", n_samples=n_anchor,
                                sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    launches = launch_counts()
    routes = asp.sampler.history.mutation_route
    out["anchor"] = {"log_z": post.log_evidence,
                     "log_z_err": post.log_evidence_error,
                     "n_mutations": len(routes), "launches": launches}
    log(f"user target anchor, n={n_anchor}: {out['anchor']} (truth "
        f"{truth:.4f})")
    if set(routes) != {"fused_kernel"}:
        raise AssertionError(f"user target: mutations left B2: {routes}")
    if on_card and launches["chain"] != len(routes):
        raise AssertionError(f"user target: {launches} for {len(routes)} "
                             "mutations")
    check_result(post, n_anchor, truth, p.dims)
    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    store_sample_history=False,
                    sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    ladders = ladder_turns(asp, pipeline, {"chain": 1}, truth)
    (_, lad), = asp.ladder_cache.values() if on_card else ((None, None),)
    per_rung = captured_launches(lad) if on_card else None
    if on_card and (per_rung != {"coupling": 0, "chain": 1, "maf": 0}
                    or not ladders["ladders_agree_bitwise"]):
        raise AssertionError(f"user target device ladder: {per_rung} a "
                             f"rung, {ladders}")
    replay = replay_check(asp) if on_card else None
    split = dict(pipeline, sampler_kwargs=dict(n_steps=CHAIN_STEPS,
                                               fused_chain=False))
    ladders_split = ladder_turns(asp, split, {"coupling": CHAIN_STEPS + 2},
                                 truth)
    out.update(ladders=ladders, per_rung=per_rung, replay_vs_eager=replay,
               ladders_split=ladders_split)
    if on_card:
        out["times"] = user_chain_times(device, n_pipeline)
    log(f"user target pipelines, n={n_pipeline}: B2 {ladders}; split "
        f"{ladders_split}")
    return out


#: the flows whose gradients ``gradient_check`` holds through B1 and B4:
#: (architecture, its weights' seed)
def gradient_flows() -> dict:
    from aspire_tpu_torch.flows.architectures import maf_rqs, nsf_tpu

    return {"nsf-tpu d=2": (nsf_tpu(2), 21), "nsf-tpu d=4": (nsf_tpu(4), 22),
            "nsf-tpu d=5": (nsf_tpu(5), 23), "maf-rqs d=4": (maf_rqs(4), 24)}


def gradient_check(device, name: str, n: int) -> dict:
    """``Flow.log_prob`` and its gradient in x of ``gradient_flows``'s
    ``name`` (weights perturbed by 0.1) on n points: through the kernel
    (B1 or B4 forward, its plain recompute backward) against the plain
    float32 path. The value meets the card rule (float64 deciding the
    points where they disagree). The gradient must be the plain path's
    vector-Jacobian product at the kernel pass's own cotangents bit for
    bit: the backward is that plain recompute, so a difference is a fault.
    Beside it, the gradient's largest difference from the plain path's
    own (whose cotangents come from the plain z) and both against float64,
    reported."""
    import torch

    from aspire_tpu_torch.flows import Flow
    from aspire_tpu_torch.flows.bijectors import standard_normal_log_prob
    from aspire_tpu_torch.ops import fused_coupling as FC

    arch, seed = gradient_flows()[name]
    arch, params = perturbed_flow(device, seed, arch, 0.1)
    flow = Flow(dims=arch.dims, architecture=arch, device=device)
    flow.params = params
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = 1.5 * torch.randn((n, arch.dims), generator=gen, device=device)
    fused = FC.should_fuse_maf if name.startswith("maf") else FC.should_fuse
    if device.type == "cuda" and not fused(arch, x):
        raise AssertionError(f"{name}: no kernel takes the flow")

    def tracked(fn, params, x):
        """``fn(params, x)`` with autograd tracking a copy of x."""
        xg = x.detach().requires_grad_(True)
        return fn(params, xg), xg

    before = launch_counts()
    xg = x.detach().requires_grad_(True)
    lp_k = flow.log_prob(xg)
    g_k, = torch.autograd.grad(lp_k.sum(), xg)
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    with torch.no_grad():
        z_k, _ = arch.forward(params, x)
    zk = z_k.requires_grad_(True)
    gz, = torch.autograd.grad(standard_normal_log_prob(zk).sum(), zk)
    (z_p, ld_p), xp = tracked(arch.forward_plain, params, x)
    g_vjp, = torch.autograd.grad((z_p, ld_p), xp,
                                 (gz, torch.ones_like(ld_p)),
                                 retain_graph=True)
    lp_p = standard_normal_log_prob(z_p) + ld_p
    g_p, = torch.autograd.grad(lp_p.sum(), xp)
    (z_e, ld_e), xe = tracked(arch.forward_plain, as_float64(params),
                              x.double())
    lp_e = standard_normal_log_prob(z_e) + ld_e
    g_e, = torch.autograd.grad(lp_e.sum(), xe)
    bad = assert_kernel_close(lp_k.detach(), lp_p.detach(), lp_e.detach(),
                              f"{name} log_prob")
    out = {"n": n, "launches": launched,
           "value_max_abs_err": max_err(lp_k.detach(), lp_p.detach()),
           "value_ill_conditioned_points": bad,
           "grad_equals_plain_vjp": bool(torch.equal(g_k, g_vjp)),
           "grad_max_abs_diff_plain": max_err(g_k, g_p),
           "grad_max_abs_err_f64": max_err(g_k.double(), g_e),
           "plain_grad_max_abs_err_f64": max_err(g_p.double(), g_e)}
    log(f"gradient through the kernel, {name}: {out}")
    kernel = "maf" if name.startswith("maf") else "coupling"
    if not out["grad_equals_plain_vjp"] or (
            device.type == "cuda" and launched[kernel] != 1):
        raise AssertionError(f"{name} gradient: {out}")
    return out


def rwmh_chain_setup(device, n: int, steps: int):
    """``chain_setup``'s chain with RWMH in place of tpCN, as
    ``GradientSMC(kernel="rwmh")`` configures it: target acceptance 0.234,
    adaptation rate 0.05, initial step 0.1 (``max_log_step`` 2.3)."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    cfg, params, z0, beta, _, refs, target, dt, gen = chain_setup(
        device, n, steps)
    cfg = FM.ChainConfig(cfg.arch, "rwmh", steps, target_acceptance=0.234,
                         adaptation_rate=0.05)
    step0 = torch.full((n // FM.TILE,), 0.1, device=device)
    return cfg, params, z0, beta, step0, refs, target, dt, gen


def rwmh_chain_times(device, n: int, steps: int) -> dict:
    """B2 with RWMH and with tpCN (``chain_setup``) on the same flow, start
    points and target, timed in turns (RWMH, tpCN, tpCN, RWMH: events,
    single calls), each noted for a reading alone; plain torch beside."""
    from functools import partial

    from aspire_tpu_torch.ops import fused_mutation as FM

    calls = {}
    for kernel, setup in (("rwmh", rwmh_chain_setup), ("tpcn", chain_setup)):
        cfg, params, z0, beta, step0, refs, target, dt, _ = setup(
            device, n, steps)
        calls[kernel] = partial(FM.fused_mh_chain, cfg, params, z0, beta,
                                (1, 2), step0, *refs, target,
                                data_transform=dt)
        if kernel == "rwmh":
            plain = partial(FM.chain_plain, cfg, params, z0, beta, step0,
                            *refs, target, data_transform=dt, seed=(1, 2))
    out = {k: {"ms": [], "ms_single_call": []} for k in calls}
    for kernel in ("rwmh", "tpcn", "tpcn", "rwmh"):
        out[kernel]["ms"].append(cuda_ms(calls[kernel]))
        out[kernel]["ms_single_call"].append(cuda_ms_single(calls[kernel]))
    out["rwmh"]["plain_ms"] = cuda_ms(plain, 3)
    for kernel, fn in calls.items():
        kernel_ms_later(out[kernel], "kernel_ms", fn, "chain_kernel", reps=5)
    log(f"B2 with RWMH and tpCN in turns, n={n}: {out}")
    return out


#: the samplers of the JAX package's validation rows on the mixture
#: (``benchmarks/validate.py:30-52``) and their ``sampler_kwargs``
#: the anchors at N_VALIDATE on the mixture; NUTS's chain and tree depth
#: cut (from 5 steps at the default depth 8, 78.7-118.5 s) to keep it under
#: 30 s, its gate unchanged
GRADIENT_ANCHORS = {
    "rwmh_smc": {"n_steps": 20},
    "emcee_smc": {"n_steps": 20},
    "mala_smc": {"n_steps": 100},
    "hmc_smc": {"n_steps": 5, "n_leapfrog": 10},
    "nuts_smc": {"n_steps": 3, "max_depth": 5},
}

#: the 131072 pipelines' samplers on the mixture, both ladders in turns,
#: with their chain lengths cut (depth, not width) to keep the phase short,
#: and the B1 launches of a rung that follow from their evaluations: one
#: for the start, one per target evaluation, one for the refresh (a MALA
#: step one, an HMC step n_leapfrog, a stretch step two half batches)
GRADIENT_PIPELINES = {
    "rwmh_smc": ({"n_steps": 20}, {"coupling": 0, "chain": 1, "maf": 0}),
    "mala_smc": ({"n_steps": 5}, {"coupling": 7, "chain": 0, "maf": 0}),
    "hmc_smc": ({"n_steps": 1, "n_leapfrog": 5},
                {"coupling": 7, "chain": 0, "maf": 0}),
    "emcee_smc": ({"n_steps": 10}, {"coupling": 22, "chain": 0, "maf": 0}),
}

#: NUTS at 131072 (the host ladder): its chain and tree depth cut
NUTS_PIPELINE = {"n_steps": 2, "max_depth": 4}


def mixture_aspire(device, seed: int = 1):
    """The 4-d Gaussian mixture fitted as ``validate_aspire`` fits a
    validation row (nsf-tpu at ``seed``, 25 epochs at batch 512 on 8192 of
    its initial draws of ``default_rng(0)``)."""
    return validate_aspire(device, "mixture", seed)


def gradient_anchor(asp, sampler: str, kwargs: dict, n: int,
                    truth: float | None, kernels: bool = True,
                    **sample_kw) -> dict:
    """One SMC run of ``sampler`` at n on ``asp``'s default path: its log
    Z (gated against ``truth`` by ``benchmarks/validate.py``'s rule when
    given), routes, ladder, launches and wall; finite samples of the
    problem's shape. An RWMH run mutates on B2 once per mutation and no
    B1; a gradient or stretch run on the split chain, on B1 (with
    ``kernels``; without, on no kernel at all: a flow no kernel takes)."""
    import torch

    reset_launch_counts()
    on_card = asp.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = asp.sample_posterior(sampler=sampler, n_samples=n,
                                store_sample_history=False,
                                sampler_kwargs=dict(kwargs), **sample_kw)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampler_ = asp.sampler
    routes = sampler_.history.mutation_route
    launches = launch_counts()
    out = {"log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
           "truth": truth, "wall_s": wall, "rungs": len(routes),
           "routes": sorted(set(routes)), "launches": launches,
           "ladder": "device" if sampler_.ladder is not None else "host",
           "evaluations": sampler_.n_likelihood_evaluations}
    log(f"{sampler} {kwargs} at n={n}: {out}")
    want = "fused_kernel" if sampler == "rwmh_smc" else "split"
    if set(routes) != {want}:
        raise AssertionError(f"{sampler}: mutations off the {want} route: "
                             f"{routes}")
    if on_card and (any(launches.values()) if not kernels else (
            (want == "fused_kernel" and launches["chain"] != len(routes))
            or (want == "split" and (launches["chain"] or launches[
                "coupling"] < 2 * len(routes))))):
        raise AssertionError(f"{sampler}: launches {launches} for "
                             f"{len(routes)} mutations")
    if truth is not None:
        check_result(post, n, truth, asp.dims)
    return out


def baseline_config3(device) -> dict:
    """BASELINE config 3 as ``examples/gradient_smc_example.py`` runs it:
    the funnel at d = 5, the default flow (``maf``, affine MAF, plain
    torch: no kernel at 500 particles) fitted for 30 epochs on 4000 draws
    of ``default_rng(0)``, ``nuts_smc`` on 500 particles at target
    efficiency 0.8, 10 steps from step size 0.1, ``max_depth`` 6 (seeded
    here, so the run repeats); its log Z gated against ``funnel_truth``."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import FunnelProblem

    p = FunnelProblem(dims=5)
    init = Samples(p.draw_initial_samples(np.random.default_rng(0), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=5, flow_backend="maf", seed=1, device=device)
    t0 = time.perf_counter()
    asp.fit(init, n_epochs=30)
    fit_s = time.perf_counter() - t0
    out = gradient_anchor(asp, "nuts_smc", dict(
        n_steps=10, step_size=0.1, max_depth=6), 500, funnel_truth(),
        kernels=False, target_efficiency=0.8)
    return dict(out, fit_s=fit_s)


def maf_gradient_pipeline(device, n: int) -> dict:
    """maf-rqs, fitted as ``phase_maf_main_path`` fits it, with
    ``mala_smc`` at n (``GRADIENT_PIPELINES``' chain) on the device ladder
    in turns with the host ladder, two runs each: every value of its
    chains on B4, the launches a rung its capture counted."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 4000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="maf-rqs",
                 seed=1, device=device)
    asp.fit(init, n_epochs=20, batch_size=512, learning_rate=3e-3)
    kw, per_rung = GRADIENT_PIPELINES["mala_smc"]
    per_rung = {"coupling": 0, "chain": 0, "maf": per_rung["coupling"]}
    run = dict(sampler="mala_smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=kw)
    ladders = ladder_turns(asp, run, {"maf": per_rung["maf"]},
                           turns=("device", "host"))
    on_card = device.type == "cuda"
    (_, lad), = asp.ladder_cache.values() if on_card else ((None, None),)
    captured = captured_launches(lad) if on_card else None
    if not ladders["ladders_agree_bitwise"] or (on_card
                                                and captured != per_rung):
        raise AssertionError(f"maf-rqs mala pipeline: {captured} a rung "
                             f"(want {per_rung}); {ladders}")
    return dict(ladders, per_rung=captured)


def phase_gradient_samplers(device, n_anchor: int, n_pipeline: int) -> dict:
    """The gradient and ensemble SMC samplers (``rwmh_smc``, ``mala_smc``,
    ``hmc_smc``/``blackjax_smc``, ``nuts_smc``, ``emcee_smc``) through
    ``Aspire.sample_posterior``:

    (a) the gradient of ``Flow.log_prob`` through B1 (nsf-tpu at d = 2, 4,
    5) and B4 (maf-rqs at d = 4) at N_COUPLING (``gradient_check``);
    (b) B2 with RWMH against the plain chain at N_CHAIN x CHAIN_STEPS
    (``phase_chain`` on ``rwmh_chain_setup``: injected noise, Philox
    against its replay, Philox against independent noise), and timed at
    ``n_pipeline`` in turns with B2's tpCN (``rwmh_chain_times``);
    (c) the anchors at ``n_anchor`` on the mixture fitted as the
    validation rows are (``mixture_aspire``), each sampler of
    ``GRADIENT_ANCHORS`` gated against the analytic log Z; ``rwmh_smc``
    and ``hmc_smc`` on the Rosenbrock row (one fit) and the funnel row
    (three fits, combined by ``combined_log_z``), gated against their
    quadrature truths; ``nuts_smc`` with ``device_ladder=True`` refused;
    (d) BASELINE config 3 (``baseline_config3``);
    (e) the ``n_pipeline`` pipelines on the mixture: each of
    ``GRADIENT_PIPELINES`` on the device ladder in turns with the host
    ladder (``ladder_turns``), one population for both, the launches its
    rung captured as listed; maf-rqs with ``mala_smc`` on the device
    ladder, B4's launches a rung; ``nuts_smc`` on the host ladder
    (``NUTS_PIPELINE``).
    """
    on_card = device.type == "cuda"
    out = {"gradients": {name: gradient_check(device, name, N_COUPLING)
                         for name in gradient_flows()}}
    out["rwmh_chain"] = phase_chain(device, N_CHAIN, CHAIN_STEPS,
                                    rwmh_chain_setup)
    if on_card:
        out["rwmh_times"] = rwmh_chain_times(device, n_pipeline, CHAIN_STEPS)

    p, asp = mixture_aspire(device)
    truth = p.true_log_evidence()
    out["anchors"] = {name: gradient_anchor(asp, name, kw, n_anchor, truth)
                      for name, kw in GRADIENT_ANCHORS.items()}
    try:
        asp.sample_posterior(sampler="nuts_smc", n_samples=N_CHAIN,
                             device_ladder=True,
                             sampler_kwargs=GRADIENT_ANCHORS["nuts_smc"])
        raise AssertionError("device_ladder=True ran NUTS")
    except ValueError as err:
        out["nuts_device_ladder"] = str(err)
    rows = {"rosenbrock": rosenbrock_truth(), "funnel": funnel_truth()}
    out["rows"] = {}
    for row, row_truth in rows.items():
        runs = {"rwmh_smc": [], "hmc_smc": []}
        for seed in ((1,) if row == "rosenbrock" else (1, 2, 3)):
            _, row_asp = validate_aspire(device, row, seed)
            for name in runs:
                runs[name].append(gradient_anchor(
                    row_asp, name, GRADIENT_ANCHORS[name], n_anchor, None))
        for name, rr in runs.items():
            log_z, err = (combined_log_z([r["log_z"] for r in rr],
                                         [r["log_z_err"] for r in rr],
                                         f"{row} {name}")
                          if len(rr) > 1 else (rr[0]["log_z"],
                                               rr[0]["log_z_err"]))
            v = {"log_z": log_z, "log_z_err": err, "truth": row_truth,
                 "runs": rr}
            out["rows"][f"{row} {name}"] = v
            log(f"{row} {name} anchor, n={n_anchor}: {v}")
            # benchmarks/validate.py's gate.
            if not abs(log_z - row_truth) < max(5 * err, 0.02):
                raise AssertionError(f"{row} {name} anchor off the truth: "
                                     f"{v}")
    out["config3"] = baseline_config3(device)

    out["pipelines"] = {}
    for name, (kw, per_rung) in GRADIENT_PIPELINES.items():
        run = dict(sampler=name, n_samples=n_pipeline,
                   store_sample_history=False, sampler_kwargs=kw)
        # Two turns for the gradient chains (seconds a run), six else.
        turns = (("device", "host")
                 if name in ("mala_smc", "hmc_smc") else
                 ("device", "host", "host", "device", "device", "host"))
        ladders = ladder_turns(asp, run, {k: v for k, v in per_rung.items()
                                          if v}, turns=turns)
        (_, lad), = (asp.ladder_cache.values() if on_card
                     else ((None, None),))
        captured = captured_launches(lad) if on_card else None
        out["pipelines"][name] = dict(ladders, per_rung=captured)
        if not ladders["ladders_agree_bitwise"] or (on_card
                                                    and captured != per_rung):
            raise AssertionError(f"{name} pipeline: {captured} a rung (want "
                                 f"{per_rung}); {ladders}")
    out["maf_rqs_mala"] = maf_gradient_pipeline(device, n_pipeline)
    out["nuts_pipeline"] = gradient_anchor(asp, "nuts_smc", NUTS_PIPELINE,
                                           n_pipeline, None)
    if out["nuts_pipeline"]["ladder"] != "host":
        raise AssertionError("nuts_smc took the device ladder")
    return out


def report_gradient(card: str, gradient: dict) -> None:
    """Print ``phase_gradient_samplers``' results, one line each."""
    for name, v in gradient["gradients"].items():
        print(f"[{card}] gradient of Flow.log_prob through the kernel, "
              f"{name}, n={v['n']}: value max |kernel - plain| "
              f"{v['value_max_abs_err']:.3g} "
              f"({v['value_ill_conditioned_points']} ill-conditioned "
              f"points); gradient the plain VJP at the kernel's cotangents "
              f"bit for bit: {v['grad_equals_plain_vjp']}; max |gradient - "
              f"plain gradient| {v['grad_max_abs_diff_plain']:.3g}; vs "
              f"float64: through the kernel {v['grad_max_abs_err_f64']:.3g},"
              f" plain {v['plain_grad_max_abs_err_f64']:.3g}", flush=True)
    rt = gradient["rwmh_times"]
    print(f"[{card}] chain kernel B2 with RWMH, n={N_PIPELINE}, "
          f"{CHAIN_STEPS} steps: {rt['rwmh']['ms']} ms events, "
          f"{rt['rwmh']['kernel_ms']:.4f} ms alone, in turns with tpCN "
          f"{rt['tpcn']['ms']} ms events, {rt['tpcn']['kernel_ms']:.4f} ms "
          f"alone (plain torch {rt['rwmh']['plain_ms']:.4f} ms); against "
          f"the plain chain at {N_CHAIN} x {CHAIN_STEPS}: max |diff| "
          f"{gradient['rwmh_chain']['max_abs_err']:.3g}", flush=True)
    for name, v in gradient["anchors"].items():
        print(f"[{card}] {name} on the 4-d mixture (nsf-tpu, fitted as the "
              f"validation rows), n={N_VALIDATE}, {GRADIENT_ANCHORS[name]}: "
              f"log Z {v['log_z']:.4f} +/- {v['log_z_err']:.4f} vs analytic "
              f"{v['truth']:.4f}; {v['rungs']} rungs on the {v['ladder']} "
              f"ladder in {v['wall_s']:.3f} s, launches {v['launches']}",
              flush=True)
    for key, v in gradient["rows"].items():
        print(f"[{card}] {key} on its validation row, n={N_VALIDATE}: log Z "
              f"{v['log_z']:.4f} +/- {v['log_z_err']:.4f} vs quadrature "
              f"{v['truth']:.4f} ({len(v['runs'])} fit(s); walls "
              f"{[round(r['wall_s'], 3) for r in v['runs']]} s, launches "
              f"{v['runs'][0]['launches']})", flush=True)
    c3 = gradient["config3"]
    print(f"[{card}] BASELINE config 3 (funnel d=5, maf, nuts_smc, 500 "
          f"particles, efficiency 0.8, 10 steps, max_depth 6): log Z "
          f"{c3['log_z']:.4f} +/- {c3['log_z_err']:.4f} vs quadrature "
          f"{c3['truth']:.4f}; {c3['rungs']} rungs on the {c3['ladder']} "
          f"ladder, {c3['evaluations']} evaluations, fit {c3['fit_s']:.2f} "
          f"s, SMC {c3['wall_s']:.3f} s", flush=True)
    for name, v in (*gradient["pipelines"].items(),
                    ("maf-rqs mala_smc", gradient["maf_rqs_mala"])):
        print(f"[{card}] {name} pipeline, n={N_PIPELINE}: device ladder "
              f"{v['device_s']:.4f} s vs host ladder {v['host_s']:.4f} s "
              f"(medians in turns; {v['rungs']} rungs, per rung "
              f"{v['per_rung']}; capture {v['capture_s']:.3f} s); one "
              f"population: {v['ladders_agree_bitwise']}; log Z "
              f"{v['log_z']:.4f} +/- {v['log_z_err']:.4f} vs host "
              f"{v['host_log_z']:.4f}", flush=True)
    v = gradient["nuts_pipeline"]
    print(f"[{card}] nuts_smc pipeline, n={N_PIPELINE}, {NUTS_PIPELINE}, "
          f"host ladder: {v['wall_s']:.3f} s, {v['rungs']} rungs, launches "
          f"{v['launches']}, {v['evaluations']} evaluations; log Z "
          f"{v['log_z']:.4f} +/- {v['log_z_err']:.4f}", flush=True)


def rwmh_kernel_row(gradient: dict, b2_bound: dict) -> dict:
    """The kernels line's row of B2 with RWMH."""
    rt = gradient["rwmh_times"]
    return {
        "name": "chain_kernel B2, RWMH", "route": "cuda",
        "config": "rwmh_smc (GradientSMC, kernel id 2): nsf-tpu on the 4-d "
                  "mixture; times: chain_setup's flow and target, RWMH from "
                  "step 0.1",
        "source": "aspire_tpu_torch/csrc/chain.cu",
        "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
        "launches": gradient["pipelines"]["rwmh_smc"]["launches"]["chain"],
        "launches_run": "rwmh_smc pipeline, device ladder",
        "launches_per_rung": gradient["pipelines"]["rwmh_smc"]["per_rung"],
        "launches_anchor": gradient["anchors"]["rwmh_smc"]["launches"][
            "chain"],
        "max_abs_err": gradient["rwmh_chain"]["max_abs_err"],
        "ms": sum(rt["rwmh"]["ms"]) / 2,
        "ms_single_call": sum(rt["rwmh"]["ms_single_call"]) / 2,
        "kernel_ms": rt["rwmh"]["kernel_ms"],
        "plain_ms": rt["rwmh"]["plain_ms"],
        "tpcn_ms": rt["tpcn"]["ms"], "tpcn_kernel_ms": rt["tpcn"]["kernel_ms"],
        **b2_bound, "library_ms": None}


#: ``benchmarks/validate.py``'s last SMC rows (:42-51) and the waste-free
#: run of ``examples/evidence_example.py`` (:83), on the 4-d mixture at
#: N_VALIDATE: label -> (sampler, sample_posterior keywords)
SMC_OPTION_ROWS = {
    "smc+windowed_tau": ("smc", {"sampler_kwargs": {
        "n_steps": 20, "windowed_tau": True}}),
    "mala_smc+jackknife5": ("mala_smc", {"sampler_kwargs": {"n_steps": 10},
                                         "n_replicates": 5}),
    "mala_smc+flow_moves+jackknife5": ("mala_smc", {"sampler_kwargs": {
        "n_steps": 10, "flow_moves": 5}, "n_replicates": 5}),
    "smc+waste_free": ("smc", {"sampler_kwargs": {
        "n_steps": 16, "waste_free": True}}),
}

#: the options' N_PIPELINE pipelines on the mixture (tpCN, both ladders in
#: turns) and the launches a rung captures that follow from the code: B1
#: once for the chain's start, once per step (the target's tempered
#: density) and once for the refresh, plus per flow move step one B1 (the
#: current points' flow density) and one B3 (the proposal, counted under
#: "coupling" too and alone under "b3"); B2 never
SMC_OPTION_PIPELINES = {
    "waste_free": ({"n_steps": 16, "waste_free": True},
                   {"coupling": 18, "chain": 0, "maf": 0, "b3": 0}),
    "windowed_tau": ({"n_steps": 20, "windowed_tau": True},
                     {"coupling": 22, "chain": 0, "maf": 0, "b3": 0}),
    "flow_moves": ({"n_steps": 10, "flow_moves": 5},
                   {"coupling": 32, "chain": 0, "maf": 0, "b3": 10}),
}

#: the waste-free/standard evaluation ratio's ceiling
#: (``tests/test_integration.py:735``)
WASTE_FREE_EVAL_RATIO = 0.4


def captured_b3(ladder) -> int:
    """The B3 launches ``ladder``'s capture counted (``FC.sampling_launches``,
    also inside ``captured_launches``' coupling count)."""
    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import fused_coupling as FC

    return ladder.captured[_build.LaunchCounter.made.index(
        FC.sampling_launches)]


def smc_option_row(asp, label: str, truth: float, n: int) -> dict:
    """One of ``SMC_OPTION_ROWS`` at n on ``asp``'s default path, gated by
    ``benchmarks/validate.py``'s rule (``check_result``; a replicated row
    on its combined log Z and error): its log Z, walls, routes, launches
    (B3 alone under "b3") and evaluations."""
    import torch

    sampler, kw = SMC_OPTION_ROWS[label]
    sync = torch.cuda.synchronize if asp.device.type == "cuda" else (
        lambda: None)
    reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    post = asp.sample_posterior(sampler=sampler, n_samples=n,
                                store_sample_history=False, **kw)
    sync()
    wall = time.perf_counter() - t0
    hist = asp.sampler.history
    out = {"log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
           "truth": truth, "wall_s": wall, "rungs": len(hist.beta),
           "routes": sorted(set(hist.mutation_route)),
           "launches": {**launch_counts(), "b3": sampling_launches()},
           "evaluations": asp.sampler.n_likelihood_evaluations,
           "ladder": "device" if asp.sampler.ladder is not None else "host",
           "tau_range": [min(hist.mcmc_autocorr), max(hist.mcmc_autocorr)],
           "replicates": None}
    reps = getattr(post, "log_evidence_replicates", None)
    if reps is not None:
        out["replicates"] = [float(v) for v in reps]
    log(f"{label} at n={n}: {out}")
    if out["routes"] != ["split"] or out["launches"]["chain"]:
        raise AssertionError(f"{label}: mutations off the split route: {out}")
    if not 1.0 <= out["tau_range"][0] <= out["tau_range"][1] <= 2e4:
        raise AssertionError(f"{label}: a tau out of [1, 2e4]: {out}")
    check_result(post, n, truth, asp.dims)
    return out


def flow_move_cost(asp, n: int) -> dict:
    """What the flow moves cost a rung: the device ladder's replays of the
    flow-move pipeline against the same 10-step tpCN split chain without
    them (``fused_chain=False``). The ladder cache holds one graph, so the
    two take blocks in turns (on, off, off, on), each block a run that
    captures its graph and two timed runs that replay it; medians of the 4
    walls of each (host clock to ``torch.cuda.synchronize()``), and the
    seconds a rung more."""
    import torch

    kw = SMC_OPTION_PIPELINES["flow_moves"][0]
    runs = {"on": kw, "off": {"n_steps": kw["n_steps"], "fused_chain": False}}
    walls, rungs = {"on": [], "off": []}, {}
    for name in ("on", "off", "off", "on"):
        for timed_run in (False, True, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, hist = asp.sample_posterior(
                sampler="smc", n_samples=n, store_sample_history=False,
                sampler_kwargs=runs[name], return_history=True)
            torch.cuda.synchronize()
            if timed_run:
                walls[name].append(time.perf_counter() - t0)
            rungs[name] = len(hist.beta)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    out = {"on_s": med["on"], "off_s": med["off"], "walls": walls,
           "rungs": rungs, "per_rung_s": med["on"] / rungs["on"]
           - med["off"] / rungs["off"]}
    log(f"flow moves' cost at n={n}: {out}")
    return out


def phase_smc_options(device, n_rows: int, n_pipeline: int) -> dict:
    """The SMC options ``windowed_tau``, ``waste_free`` and ``flow_moves``
    on the 4-d mixture fitted as the validation rows are
    (``mixture_aspire``) and on BASELINE config 5:

    (a) ``SMC_OPTION_ROWS`` at ``n_rows``, each within
    ``benchmarks/validate.py``'s gate of the analytic log Z;
    (b) the waste-free pipeline at ``n_pipeline`` on both ladders in turns
    (``ladder_turns``): one population for both, the launches a rung
    captured as listed, every run's evaluations under
    ``WASTE_FREE_EVAL_RATIO`` times the standard 16-step run's (B2);
    (c) the windowed-tau and flow-move (tpCN) pipelines the same way,
    every recorded tau in [1, 2e4], every run's B3 launches one for the
    initial draws plus one per chain step of every rung; on the card, the
    flow moves' cost a rung (``flow_move_cost``);
    (d) config 5 waste-free: ``n_steps=32, waste_free=True`` at N_HIER on
    the device ladder (M = 32768 chains, B1 in the wide form, a stored
    chain of 32 x 32768 x 32 floats), twice (the capture, then replays),
    printed beside the standard run's, not gated (PERF.md section 7).
    """
    import torch

    on_card = device.type == "cuda"
    p, asp = mixture_aspire(device)
    truth = p.true_log_evidence()
    out = {"rows": {label: smc_option_row(asp, label, truth, n_rows)
                    for label in SMC_OPTION_ROWS}}

    reset_launch_counts()
    std = asp.sample_posterior(sampler="smc", n_samples=n_pipeline,
                               store_sample_history=False,
                               sampler_kwargs={"n_steps": 16})
    out["standard_evaluations"] = asp.sampler.n_likelihood_evaluations
    out["standard_log_z"] = std.log_evidence
    out["pipelines"] = {}
    for name, (kw, per_rung) in SMC_OPTION_PIPELINES.items():
        run = dict(sampler="smc", n_samples=n_pipeline,
                   store_sample_history=False, sampler_kwargs=kw)
        ladders = ladder_turns(asp, run, {"coupling": per_rung["coupling"]},
                               turns=("device", "host", "host", "device"))
        (_, lad), = (asp.ladder_cache.values() if on_card
                     else ((None, asp.sampler.ladder),))
        captured = ({**captured_launches(lad), "b3": captured_b3(lad)}
                    if on_card else per_rung)
        out["pipelines"][name] = dict(ladders, per_rung=captured)
        runs = ladders["per_run"]
        faults = []
        if not ladders["ladders_agree_bitwise"] or captured != per_rung:
            faults.append(f"per rung {captured} (want {per_rung})")
        if any(not 1.0 <= r["tau_range"][0] <= r["tau_range"][1] <= 2e4
               for r in runs):
            faults.append("a tau out of [1, 2e4]")
        if on_card and any(r["b3"] != 1 + per_rung["b3"] * r["rungs"]
                           for r in runs):
            faults.append("B3 launches not 1 + one per chain step")
        if name == "waste_free" and any(
                r["evaluations"] >= WASTE_FREE_EVAL_RATIO
                * out["standard_evaluations"] for r in runs):
            faults.append(f"evaluations not under {WASTE_FREE_EVAL_RATIO} "
                          f"x the standard {out['standard_evaluations']}")
        if faults:
            raise AssertionError(f"{name} pipeline: {faults}; {ladders}")
    if on_card:
        out["flow_move_cost"] = flow_move_cost(asp, n_pipeline)

    _, hasp, _ = hierarchical_aspire(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (
        lambda: None)
    runs = []
    for _ in range(2):
        reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        post, hist = hasp.sample_posterior(
            sampler="smc", n_samples=N_HIER, store_sample_history=False,
            sampler_kwargs=dict(n_steps=HIER_STEPS, waste_free=True),
            return_history=True)
        sync()
        lad = hasp.sampler.ladder
        runs.append({"smc_wall_s": time.perf_counter() - t0,
                     "log_z": post.log_evidence,
                     "log_z_err": post.log_evidence_error,
                     "rungs": len(hist.beta),
                     "evaluations": hasp.sampler.n_likelihood_evaluations,
                     "launches": launch_counts(),
                     "per_rung": (captured_launches(lad) if on_card
                                  else {"coupling": HIER_STEPS + 2}),
                     "capture_s": lad.capture_s, "replays": lad.replays})
        log(f"config 5 waste-free at n={N_HIER}: {runs[-1]}")
        if (tuple(post.x.shape) != (N_HIER, 32)
                or not bool(torch.isfinite(post.x).all())
                or not math.isfinite(post.log_evidence)
                or set(hist.mutation_route) != {"split"}
                or runs[-1]["per_rung"]["coupling"] != HIER_STEPS + 2):
            raise AssertionError(f"config 5 waste-free: {runs[-1]}")
    out["config5"] = runs
    return out


def report_smc_options(card: str, opts: dict, hier: dict | None) -> None:
    """Print ``phase_smc_options``' results, one line each."""
    for label, v in opts["rows"].items():
        print(f"[{card}] {label} on the 4-d mixture (nsf-tpu, fitted as the "
              f"validation rows), n={N_VALIDATE}: log Z {v['log_z']:.4f} +/- "
              f"{v['log_z_err']:.4f} vs analytic {v['truth']:.4f}; "
              f"{v['rungs']} rungs on the {v['ladder']} ladder in "
              f"{v['wall_s']:.3f} s, {v['evaluations']} evaluations, "
              f"launches {v['launches']}, tau {v['tau_range']}"
              + (f", replicates {v['replicates']}" if v["replicates"]
                 else ""), flush=True)
    c = opts.get("flow_move_cost")
    rungs = c["rungs"] if c else {}
    print(f"[{card}] flow moves' cost, n={N_PIPELINE}, 10-step tpCN on the "
          f"device ladder: {c['on_s']:.4f} s with flow_moves=5 "
          f"({rungs['on']} rungs) vs {c['off_s']:.4f} s without "
          f"({rungs['off']} rungs), medians in turns: "
          f"{c['per_rung_s'] * 1e3:.2f} ms a rung more" if c else
          f"[{card}] flow moves' cost not measured (no card)", flush=True)
    for name, v in opts["pipelines"].items():
        print(f"[{card}] {name} pipeline, n={N_PIPELINE}: device ladder "
              f"{v['device_s']:.4f} s vs host ladder {v['host_s']:.4f} s "
              f"(medians in turns; {v['rungs']} rungs, per rung "
              f"{v['per_rung']}; capture {v['capture_s']:.3f} s); one "
              f"population: {v['ladders_agree_bitwise']}; log Z "
              f"{v['log_z']:.4f} +/- {v['log_z_err']:.4f} vs host "
              f"{v['host_log_z']:.4f}; evaluations "
              f"{[r['evaluations'] for r in v['per_run']]} (standard "
              f"16-step run {opts['standard_evaluations']}); B3 "
              f"{[r['b3'] for r in v['per_run']]}", flush=True)
    std = (f"standard run {hier['log_z']:.4f} +/- {hier['log_z_err']:.4f}, "
           f"smc_wall_s {hier['smc_wall_s']:.2f}, {hier['smc_evaluations']} "
           f"evaluations, {hier['n_temperatures']} temperatures"
           if hier else "standard run not made in this call")
    for i, r in enumerate(opts["config5"]):
        print(f"[{card}] BASELINE config 5 waste-free (n={N_HIER}, "
              f"{HIER_STEPS} steps, {N_HIER // HIER_STEPS} chains), run {i}: "
              f"log Z {r['log_z']:.4f} +/- {r['log_z_err']:.4f}, smc_wall_s "
              f"{r['smc_wall_s']:.2f} (capture {r['capture_s']:.3f} s), "
              f"{r['evaluations']} evaluations, {r['rungs']} temperatures, "
              f"per rung {r['per_rung']}; {std}", flush=True)


def smc_options_alone() -> dict:
    """``phase_smc_options`` alone after the kernels' build (with the
    mixture's and config 5's fits), its lines printed; its seconds."""
    import torch

    from aspire_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    device = torch.device("cuda")
    mixture_aspire(device)
    hierarchical_aspire(device)
    t0 = time.perf_counter()
    opts = phase_smc_options(device, N_VALIDATE, N_PIPELINE)
    phase_s = time.perf_counter() - t0
    report_smc_options(card_line(), opts, None)
    return {"phase_s": phase_s,
            "rows": {k: v["wall_s"] for k, v in opts["rows"].items()},
            "pipelines": {k: [v["device_s"], v["host_s"]]
                          for k, v in opts["pipelines"].items()},
            "flow_move_cost": opts.get("flow_move_cost"),
            "config5": [r["smc_wall_s"] for r in opts["config5"]]}


#: ``phase_mesh``: the resampling schedules, each job's time limit (s),
#: its data-parallel fit
MESH_IMPLS = ("auto", "ring", "alltoall")
MESH_JOB_TIMEOUT_S = 420
MESH_DP_FIT = dict(n_epochs=3, batch_size=512, learning_rate=3e-3)
#: the all-to-all's bucket in the op-level overflow check: on two ranks the
#: default cap is the whole output block, which no pair can pass
MESH_OVERFLOW_CAP = 16
#: (f) the checkpointed runs' population (the pipeline's n over this:
#: 16384 on the card) and the rung they resume from
MESH_CK_PART, MESH_RESUME_RUNG = 8, 3
#: (g) the population moves on the mesh: their population (n over this:
#: 4096 on the card) and options
MESH_MOVES_PART = 32
MESH_MOVES = {"emcee_smc": dict(n_steps=CHAIN_STEPS),
              "nuts_smc": dict(n_steps=2, max_depth=4)}
#: (h) parallel tempering with its walkers sharded, and the standalone
#: tpCN every rank runs whole
MESH_PT = dict(n_samples=512, n_temperatures=4, n_steps=8, swap_every=2)
MESH_TPCN = dict(n_samples=4096, n_steps=CHAIN_STEPS, step_fn="tpcn")
#: (i) the CNF's data-parallel fit: one epoch of the main path's draws
MESH_CNF_FIT = dict(n_epochs=1, batch_size=512, learning_rate=3e-3)


def mesh_aspire(device, state=None):
    """The main path's problem and Aspire (the 4-d mixture, nsf-tpu at
    seed 1): fitted as ``phase_main_path`` fits it, or, given ``state``
    (the fitted flow's parameters and data transform), built and loaded
    with it, never fitted."""
    import numpy as np

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, parameters=p.parameters, flow_backend="nsf",
                 architecture="nsf-tpu", seed=1, device=device)
    if state is None:
        asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(42),
                                               4000)),
                n_epochs=20, batch_size=512, learning_rate=3e-3)
    else:
        asp.init_flow()
        asp.flow.params, asp.flow.data_transform = state
    return p, asp


def mesh_pipeline(asp, n: int, mesh=None, impl: str = "auto",
                  ladder: bool = False) -> dict:
    """The mixture's pipeline at ``n`` on the host ladder (``ladder``: the
    device ladder) and the split route (``fused_chain=False``, the route a
    mesh takes), 20-step tpCN, with the launch and collective counts set
    to 0 just before and read just after; on ``mesh`` with
    ``resampling_impl=impl``. Its wall (host clock to a synchronise),
    rungs, betas, log Z, population, generator state, B1/B3/B2 launches,
    collectives, and on the device ladder its mode and replays."""
    import torch

    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.parallel import mesh as M

    on_card = asp.device.type == "cuda"
    on_mesh = {} if mesh is None else dict(mesh=mesh, resampling_impl=impl)
    replays = {id(v[1]): v[1].replays for v in asp.ladder_cache.values()}
    reset_launch_counts()
    M.reset_collective_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post, hist = asp.sample_posterior(
        sampler="smc", n_samples=n, return_history=True,
        store_sample_history=False, device_ladder=ladder,
        sampler_kwargs=dict(n_steps=CHAIN_STEPS, fused_chain=False),
        **on_mesh)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, b3 = launch_counts(), FC.sampling_launches.count
    run = asp.sampler.ladder if ladder else None
    return {"wall_s": wall, "rungs": len(hist.beta), "beta": list(hist.beta),
            "log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
            "x": post.x.cpu(), "generator": asp.sampler.generator.get_state(
            ).cpu(), "b1": counts["coupling"] - b3, "b3": b3,
            "b2": counts["chain"], "routes": sorted(set(
                hist.mutation_route)), "post": post,
            "collectives": dict(M.collective_counts),
            "mode": None if run is None else run.mode,
            "replays": None if run is None else (
                run.replays - replays.get(id(run), 0))}


def mesh_checkpointed(asp, n: int, mesh, ladder: bool) -> dict:
    """(f) The mixture's run at ``n`` on the host or the device ladder
    (split route) with a checkpoint a rung, in memory (the card's machine
    has no HDF5), and its sample history (on a mesh each rank's rows);
    the same run without checkpoints; the run resumed from rung
    MESH_RESUME_RUNG's state. Each run's population, log Z, betas and
    generator state; the checkpoints' iterations; the history's rows."""
    run = dict(device_ladder=ladder, sampler_kwargs=dict(
        n_steps=CHAIN_STEPS, fused_chain=False))

    def summary(post, sampler):
        return {"x": post.x.cpu(), "log_z": post.log_evidence,
                "log_z_err": post.log_evidence_error,
                "beta": list(sampler.history.beta),
                "generator": sampler.generator.get_state().cpu()}

    states = []
    sampler = asp.init_sampler("smc", mesh=mesh)
    post = sampler.sample(n, checkpoint_callback=states.append,
                          store_sample_history=True, **run)
    out = summary(post, sampler)
    out["history"] = [
        (list(getattr(h, "shard_starts", None) or [0]), h.x.copy())
        for h in sampler.history.sample_history]
    out["iterations"] = [st["iteration"] for st in states]
    plain = asp.init_sampler("smc", mesh=mesh)
    out["plain"] = summary(plain.sample(n, store_sample_history=True,
                                        **run), plain)
    resumed = asp.init_sampler("smc", mesh=mesh)
    out["resumed"] = summary(resumed.sample(
        n, resume_from=states[MESH_RESUME_RUNG - 1], **run), resumed)
    return out


def mesh_moves(asp, n: int, mesh=None) -> dict:
    """(g) ``emcee_smc`` and ``nuts_smc`` on the mixture at ``n`` (the
    device ladder where the sampler takes it): each one's population, log
    Z, betas, generator state and collectives."""
    from aspire_tpu_torch.parallel import mesh as M

    out = {}
    for name, kwargs in MESH_MOVES.items():
        M.reset_collective_counts()
        post, hist = asp.sample_posterior(
            sampler=name, n_samples=n, return_history=True,
            sampler_kwargs=kwargs, **({} if mesh is None else dict(
                mesh=mesh)))
        out[name] = {"x": post.x.cpu(), "log_z": post.log_evidence,
                     "log_z_err": post.log_evidence_error,
                     "beta": list(hist.beta), "generator":
                     asp.sampler.generator.get_state().cpu(),
                     "collectives": dict(M.collective_counts)}
    return out


def mesh_pt(asp, mesh=None) -> dict:
    """(h) Parallel tempering with its walkers sharded (MESH_PT) and the
    standalone tpCN (MESH_TPCN, every rank the whole ensemble): their
    chains, generator states, collectives and PT's stepping-stone log Z."""
    from aspire_tpu_torch.parallel import mesh as M

    on_mesh = {} if mesh is None else dict(mesh=mesh)
    out = {}
    for name, kwargs in (("ptmcmc", MESH_PT), ("minipcn", MESH_TPCN)):
        M.reset_collective_counts()
        post = asp.sample_posterior(sampler=name, **kwargs, **on_mesh)
        out[name] = {"x": post.x.cpu(), "generator":
                     asp.sampler.generator.get_state().cpu(),
                     "collectives": dict(M.collective_counts)}
        if name == "ptmcmc":
            out[name]["log_z"], out[name]["log_z_err"] = (
                post.log_evidence_stepping_stone())
    return out


def mesh_cnf_fit(p, mesh) -> dict:
    """(i) The CNF's data-parallel fit over ``mesh``: the main path's 4000
    draws, the velocity field at its default width at seed 2, one epoch
    (MESH_CNF_FIT); its seconds, losses and parameters."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows import FlowMatching
    from aspire_tpu_torch.flows.train import param_leaves
    from aspire_tpu_torch.parallel import particle_sharding

    flow = FlowMatching(dims=4, seed=2, device=mesh.device)
    x = p.draw_initial_samples(np.random.default_rng(42), 4000)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    history = flow.fit(x, sharding=particle_sharding(mesh), **MESH_CNF_FIT)
    sync()
    return {"s": time.perf_counter() - t0,
            "loss": list(history.training_loss),
            "params": [t.detach().cpu() for t in param_leaves(flow.params)]}


def _on_card(value, device):
    """``value`` with every tensor it holds (in dicts, lists, tuples and a
    transform program) copied to ``device``."""
    import torch

    from aspire_tpu_torch.ops import fused_mutation as FM

    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, dict):
        return {k: _on_card(v, device) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_on_card(v, device) for v in value)
    if isinstance(value, FM.TDProgram):
        return FM.TDProgram(value.ops, _on_card(value.params, device),
                            value.n_params_per_op)
    return value


def two_card_check(n: int = N_CHAIN) -> dict:
    """C18: every kernel wrapper launches on its tensors' card. Each
    kernel runs on ``cuda:1`` tensors while ``cuda:0`` is the current
    device, and on the same values on ``cuda:0``: the outputs the same
    bits, one launch each. B1 and B3 (nsf-tpu), B1 with its parameters on
    ``cuda:0`` and its input on ``cuda:1`` (the packing cache hands back a
    packing on ``cuda:1``), B4 (maf-rqs), B2 (``chain_setup``'s chain,
    Philox seeded), the user target's evaluation entry, D1, D2 at Q = 4,
    D3 and D4. Raises on a difference; needs two cards."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows.architectures import maf_rqs
    from aspire_tpu_torch.ops import _build
    from aspire_tpu_torch.ops import fused_coupling as FC
    from aspire_tpu_torch.ops import fused_mutation as FM
    from aspire_tpu_torch.ops import prng as PR
    from aspire_tpu_torch.ops import staged_coupling as SC

    if torch.cuda.device_count() < 2:
        raise RuntimeError("the two-card check needs two cards")
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    arch, params = perturbed_flow(d0, seed=2)
    maf, maf_params = perturbed_flow(d0, seed=4, arch=maf_rqs(4))
    sarch, sparams = staged_flow(d0)
    gen = torch.Generator(device=d0)
    gen.manual_seed(5)
    x = 2.0 * torch.randn((n, 4), generator=gen, device=d0)
    cfg, cparams, z0, beta, step0, refs, (tid, tconsts), dt, _ = chain_setup(
        d0, n, CHAIN_STEPS)
    problem = PolynomialRegression()
    source, uconsts = problem.kernel_target(d0)
    user = FM.UserTarget(source, None)
    xu = torch.as_tensor(problem.posterior_draws(np.random.default_rng(5), n,
                                                 widen=2.0),
                         dtype=torch.float32, device=d0)
    seed = torch.tensor([11, 12], dtype=torch.int64, device=d0)
    calls = {
        "B1": lambda d: FC.coupling_kernel_apply(
            arch, "forward", _on_card(params, d), x.to(d)),
        "B3": lambda d: FC.coupling_kernel_apply(
            arch, "inverse", _on_card(params, d), x.to(d)),
        "B1, parameters on cuda:0": lambda d: FC.coupling_kernel_apply(
            arch, "forward", params, x.to(d)),
        "B4": lambda d: FC.maf_kernel_apply(maf, _on_card(maf_params, d),
                                            x.to(d)),
        "B2": lambda d: FM.fused_mh_chain(
            cfg, _on_card(cparams, d), z0.to(d), beta, seed.to(d),
            step0.to(d), *_on_card(refs, d), (tid, tconsts.to(d)),
            data_transform=_on_card(dt, d)),
        "user target": lambda d: FM.user_target_eval(
            user, uconsts.to(d), 0, xu.to(d)),
        "D1": lambda d: SC.interleaved_apply(sarch, _on_card(sparams, d),
                                             x.to(d)),
        "D2": lambda d: SC.q_apply(sarch, _on_card(sparams, d), x.to(d), 4),
        "D3": lambda d: SC.packed_apply(sarch, _on_card(sparams, d),
                                        x.to(d)),
        "D4": lambda d: (PR.prng_uniforms(PROBE_SEED, (8, n), d),),
    }
    out = {}
    with torch.cuda.device(d0):
        for name, call in calls.items():
            reset_launch_counts()
            on0 = call(d0)
            on1 = call(d1)
            torch.cuda.synchronize(d0)
            torch.cuda.synchronize(d1)
            # every counter the call moved (B3 moves two): two launches
            counts = [k for k in _build.launch_counts() if k]
            devices = sorted({str(t.device) for t in on1
                              if isinstance(t, torch.Tensor)})
            same = all(torch.equal(a.cpu(), b.cpu())
                       for a, b in zip(on0, on1)
                       if isinstance(a, torch.Tensor))
            out[name] = {"same_bits": same, "devices": devices,
                         "launches": counts}
            if not same or devices != ["cuda:1"] or set(counts) != {2}:
                raise AssertionError(f"C18, {name} on cuda:1 with cuda:0 "
                                     f"current: {out[name]}")
    log(f"C18: every wrapper launched on its tensors' card: {out}")
    return out



def mesh_overflow(x, mesh) -> dict:
    """The all-to-all's overflow at the op level: one-hot weights on
    ``x``'s rows (the whole population) give an index of one row only,
    which passes the bucket of MESH_OVERFLOW_CAP rows; the move takes the
    ring and gives ``x[idx]``."""
    import torch

    from aspire_tpu_torch.ops import resampling as R
    from aspire_tpu_torch.parallel import mesh as M

    lw = torch.full((x.shape[0],), -50.0, device=x.device)
    lw[3] = 50.0
    idx = R.systematic_resample(None, lw, u=0.5)
    M.reset_collective_counts()
    rows, took_ring = R.alltoall_move(idx, mesh.local_rows(x), mesh,
                                      cap=MESH_OVERFLOW_CAP)
    counts = dict(M.collective_counts)
    whole = M.all_gather_rows(rows, mesh)
    return {"took_ring": took_ring, "equal": bool(torch.equal(whole,
                                                               x[idx])),
            "counts": counts}


def mesh_dp_fit(p, mesh) -> dict:
    """``Flow.fit`` data-parallel over ``mesh``: the main path's 4000
    draws, an nsf-tpu flow at seed 2, MESH_DP_FIT; its seconds, losses
    and parameters (on the host)."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows import Flow
    from aspire_tpu_torch.flows.train import param_leaves
    from aspire_tpu_torch.parallel import particle_sharding

    flow = Flow(dims=4, architecture="nsf-tpu", seed=2, device=mesh.device)
    x = p.draw_initial_samples(np.random.default_rng(42), 4000)
    sync = (torch.cuda.synchronize if mesh.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    history = flow.fit(x, sharding=particle_sharding(mesh), **MESH_DP_FIT)
    sync()
    return {"s": time.perf_counter() - t0,
            "loss": list(history.training_loss),
            "params": [t.detach().cpu() for t in param_leaves(flow.params)]}


def mesh_rank(rank: int, size: int, backend: str, folder: str, n: int,
              device_type: str) -> None:
    """One rank of ``phase_mesh``'s job (a ``spawn`` child; the script is
    its ``__mp_main__``): it joins ``size`` ranks on ``backend``, builds
    the main path's Aspire on its card (the CPU where ``device_type`` is
    ``"cpu``, a rehearsal) from ``folder/flow.pt`` (no fit and
    no build: the parent built the kernels), runs the pipeline for each of
    MESH_IMPLS on the mesh after an untimed warm-up run, and on more than
    one rank the overflow check and the data-parallel fit; then (e) the
    device ladder for each of MESH_IMPLS, (f) the checkpointed runs and
    their resumes, (g) the population moves, (h) PT and the standalone
    tpCN and (i) the CNF's fit; its results go to
    ``folder/rank{rank}.pt``."""
    import torch

    from aspire_tpu_torch.parallel import initialize_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(num_processes=size, process_id=rank,
                           backend=backend,
                           init_method=f"file://{folder}/rdv")
    mesh = make_mesh(device="cpu" if device_type == "cpu" else None)
    state = torch.load(f"{folder}/flow.pt", map_location=mesh.device,
                       weights_only=False)
    p, asp = mesh_aspire(mesh.device, state)
    out = {"mesh": [mesh.size, mesh.rank, mesh.backend, str(mesh.device)],
           "runs": {}}
    # The warm-up: the process's first run, on the all-to-all, which opens
    # NCCL's connections to every peer (a first exchange between two
    # cards pays for its connection: ~0.6 s a rung of the four-card ring
    # when it came first).
    mesh_pipeline(asp, n, mesh, "alltoall")
    for impl in MESH_IMPLS:
        run = mesh_pipeline(asp, n, mesh, impl)
        post = run.pop("post")
        out["runs"][impl] = run
    if size > 1:
        out["overflow"] = mesh_overflow(post.x, mesh)
        out["dp_fit"] = mesh_dp_fit(p, mesh)
    # (e) the device ladder on the mesh, each impl: its first run captures
    # the rung (over NCCL) after an eager first rung, the second replays.
    out["ladder"] = {}
    for impl in MESH_IMPLS:
        mesh_pipeline(asp, n, mesh, impl, ladder=True)
        run = mesh_pipeline(asp, n, mesh, impl, ladder=True)
        run.pop("post")
        out["ladder"][impl] = run
    log(f"mesh rank {rank} of {size} ({backend}): (e) done")
    t0 = time.perf_counter()
    out["checkpointed"] = {
        name: mesh_checkpointed(asp, n // MESH_CK_PART, mesh, on)
        for name, on in (("host", False), ("device", True))}
    out["f_s"] = time.perf_counter() - t0
    log(f"mesh rank {rank} of {size} ({backend}): (f) {out['f_s']:.1f} s")
    t0 = time.perf_counter()
    out["moves"] = mesh_moves(asp, n // MESH_MOVES_PART, mesh)
    out["g_s"] = time.perf_counter() - t0
    log(f"mesh rank {rank} of {size} ({backend}): (g) {out['g_s']:.1f} s")
    t0 = time.perf_counter()
    out["pt"] = mesh_pt(asp, mesh)
    out["h_s"] = time.perf_counter() - t0
    log(f"mesh rank {rank} of {size} ({backend}): (h) {out['h_s']:.1f} s")
    out["cnf_fit"] = mesh_cnf_fit(p, mesh)
    log(f"mesh rank {rank} of {size} ({backend}): (i) "
        f"{out['cnf_fit']['s']:.1f} s")
    torch.save(out, f"{folder}/rank{rank}.pt")
    # spawn_ranks leaves the group once this returns, after a collection:
    # no captured ladder is left to hold NCCL (ROADMAP C19).


def mesh_job(size: int, backend: str, state, n: int,
             device_type: str) -> tuple[list, float]:
    """``size`` ranks of ``mesh_rank`` on ``backend`` with the flow
    ``state``, in a temporary folder, joined within MESH_JOB_TIMEOUT_S;
    each rank's results and the job's seconds."""
    import tempfile

    import torch

    from aspire_tpu_torch.parallel.mesh import spawn_ranks

    with tempfile.TemporaryDirectory() as folder:
        torch.save(state, f"{folder}/flow.pt")
        t0 = time.perf_counter()
        spawn_ranks(mesh_rank, size, (size, backend, folder, n,
                                      device_type),
                    timeout=MESH_JOB_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        ranks = [torch.load(f"{folder}/rank{r}.pt", weights_only=False)
                 for r in range(size)]
    return ranks, seconds


def same_run(a: dict, b: dict) -> bool:
    """Two pipelines' betas, log Z, populations and generator states the
    same bits."""
    import torch

    return (a["beta"] == b["beta"] and a["log_z"] == b["log_z"]
            and torch.equal(a["x"], b["x"])
            and torch.equal(a["generator"], b["generator"]))


def check_mesh_job(ranks: list, ref: dict, truth: float, n: int,
                   on_card: bool, exact: bool, what: str) -> None:
    """Hold a job's runs (``mesh_rank``'s results) to the reference run
    ``ref``: for each impl every rank the same bits; the first rank's
    betas, log Z and population (a)'s bits where ``exact``, else reported,
    and log Z within 1e-3 of (a)'s where the population is (a)'s bit for
    bit and within max(5 combined sigma, 0.15) where it is not (a plain
    op whose rounding depends on the rows it is given lets the chains
    part); the anchor's gate; the split route; per rank 22 B1 a rung on its
    rows, 1 B3 and no B2 on the card. With more than one rank, the
    all-to-all's overflow and the data-parallel fit. Raises on a miss."""
    import torch

    for impl in MESH_IMPLS:
        runs = [r["runs"][impl] for r in ranks]
        a = runs[0]
        lockstep = same_run(a, ref)
        tol = (1e-3 if lockstep else max(5 * math.hypot(
            a["log_z_err"], ref["log_z_err"]), 0.15))
        a.update(same_as_reference=lockstep, tolerance=tol,
                 beta_bits_as_reference=a["beta"] == ref["beta"],
                 log_z_bits_as_reference=a["log_z"] == ref["log_z"])
        need = (CHAIN_STEPS + 2) * a["rungs"]
        if not (all(same_run(a, r) for r in runs[1:])
                and (lockstep or not exact)
                and abs(a["log_z"] - ref["log_z"]) < tol
                and abs(a["log_z"] - truth) < max(5 * a["log_z_err"], 0.02)
                and bool(torch.isfinite(a["x"]).all())
                and a["x"].shape == (n, 4) and a["routes"] == ["split"]
                and all(not on_card or (r["b1"], r["b3"], r["b2"])
                        == (need, 1, 0) for r in runs)):
            raise AssertionError(f"{what}, {impl}: {runs} against the "
                                 f"reference {ref}")
    if len(ranks) == 1:
        return
    overflow = [r["overflow"] for r in ranks]
    if not all(o["took_ring"] and o["equal"] for o in overflow):
        raise AssertionError(f"{what}, the all-to-all's overflow: "
                             f"{overflow}")
    fits = [r["dp_fit"] for r in ranks]
    if not (all(all(torch.equal(u, v) for u, v in zip(
            fits[0]["params"], f["params"])) for f in fits[1:])
            and fits[0]["loss"][-1] < fits[0]["loss"][0]):
        raise AssertionError(f"{what}, the data-parallel fit: "
                             f"{[f['loss'] for f in fits]}")


def _held(got: dict, want: dict, exact: bool) -> dict:
    """A mesh run ``got`` beside the one-process run ``want``: whether its
    population, log Z, betas and generator are ``want``'s bits, and where
    they are not (``exact`` False), whether log Z is within max(5 combined
    sigma, 0.15) of ``want``'s; ``ok`` says it passed."""
    import torch

    same = (got["log_z"] == want["log_z"] and got["beta"] == want["beta"]
            and torch.equal(got["x"], want["x"])
            and torch.equal(got["generator"], want["generator"]))
    tol = max(5 * math.hypot(got.get("log_z_err", 0.0),
                             want.get("log_z_err", 0.0)), 0.15)
    near = abs(got["log_z"] - want["log_z"]) < tol
    return {"same_bits": same, "tolerance": tol, "ok": same or (
        not exact and near and bool(torch.isfinite(got["x"]).all()))}


def _same_bits(a: dict, b: dict) -> bool:
    import torch

    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else a[k] == b[k] for k in a if k != "collectives")


def check_mesh_slice_ii(ranks: list, refs: dict, truth: float, n: int,
                        on_card: bool, exact: bool, captured: bool,
                        what: str) -> dict:
    """Hold a job's (e)-(i) (``mesh_rank``) to the parent's one-process
    runs ``refs``: every rank the same bits throughout; (e) the device
    ladder's mode (``captured``: over NCCL), for each impl the reference's
    bits where ``exact`` and else ``check_mesh_job``'s tolerance, the
    anchor's gate, 22 B1 a rung a rank, 1 B3, no B2, the replays; (f) each
    ladder's checkpointed run the run without checkpoints bit for bit, a
    checkpoint a rung and one at the end, the history's rows reassembled
    the reference's history where ``exact`` and else ending in the run's
    population, the resumed run the reference's resume where ``exact``;
    (g) and (h) against the references (bits where ``exact``; PT's
    stepping stone and the moves' log Z within the tolerance), the
    standalone tpCN the reference's bits, the moves and PT gathering;
    (i) the CNF's parameters the same bits on every rank, its loss
    finite. Raises on a miss; returns what it read."""
    import numpy as np
    import torch

    first, out = ranks[0], {}
    mode = "captured" if captured else "eager"
    for impl in MESH_IMPLS:
        runs = [r["ladder"][impl] for r in ranks]
        a, ref = runs[0], refs["ladder"]
        held = _held(a, ref, exact)
        need = (CHAIN_STEPS + 2) * a["rungs"]
        ok = (all(same_run(a, r) for r in runs[1:]) and held["ok"]
              and abs(a["log_z"] - truth) < max(5 * a["log_z_err"], 0.02)
              and all(r["mode"] == mode for r in runs)
              and a["x"].shape == (n, 4) and a["routes"] == ["split"]
              and all(not on_card or (r["b1"], r["b3"], r["b2"])
                      == (need, 1, 0) for r in runs)
              and all(r["replays"] == (a["rungs"] if captured else 0)
                      for r in runs))
        out[f"e {impl}"] = held
        if not ok:
            raise AssertionError(f"{what}, (e) the device ladder, {impl}: "
                                 f"{runs} against {ref}")
    for ladder in ("host", "device"):
        got = [r["checkpointed"][ladder] for r in ranks]
        ref = refs["checkpointed"][ladder]
        a = got[0]
        rungs = len(a["beta"])
        history = [np.concatenate([b for _, b in sorted(
            (g["history"][i] for g in got), key=lambda e: e[0][0])])
            for i in range(len(a["history"]))]
        history_ok = (all(np.array_equal(h, q) for h, (_, q) in zip(
            history, ref["history"])) if exact else np.array_equal(
                history[-1], a["x"].numpy()))
        resumed = _held(a["resumed"], ref["resumed"], exact)
        out[f"f {ladder}"] = {"rungs": rungs, "history": history_ok,
                              "resumed": resumed}
        if not (all(_same_bits(g["plain"], a["plain"]) and _same_bits(
                g["resumed"], a["resumed"]) for g in got)
                and _same_bits({k: a[k] for k in a["plain"]}, a["plain"])
                and a["iterations"] == [*range(1, rungs + 1), rungs]
                and len(history) == rungs + 1 and history_ok
                and resumed["ok"] and rungs > MESH_RESUME_RUNG):
            raise AssertionError(f"{what}, (f) checkpoints on the {ladder} "
                                 f"ladder: {out[f'f {ladder}']}")
    for part, names in (("moves", MESH_MOVES), ("pt", ("ptmcmc",
                                                       "minipcn"))):
        for name in names:
            got = [r[part][name] for r in ranks]
            ref = refs[part][name]
            a = got[0]
            if name == "minipcn":
                held = {"same_bits": torch.equal(a["x"], ref["x"])
                        and torch.equal(a["generator"], ref["generator"])}
                held["ok"] = held["same_bits"] and not a["collectives"]
            elif name == "ptmcmc":
                held = _held(dict(a, beta=None), dict(ref, beta=None), exact)
                held["ok"] = held["ok"] and (len(ranks) == 1 or a[
                    "collectives"].get("all_gather_rows", 0) > 0)
            else:
                held = _held(a, ref, exact)
                held["ok"] = held["ok"] and abs(a["log_z"] - truth) < max(
                    5 * a["log_z_err"], 0.02) and (len(ranks) == 1 or a[
                        "collectives"].get("all_gather_rows", 0) > 0)
            out[f"{part} {name}"] = held
            if not (held["ok"] and all(_same_bits(g, a) for g in got[1:])):
                raise AssertionError(f"{what}, {part} {name}: {held}")
    fits = [r["cnf_fit"] for r in ranks]
    if not (all(all(torch.equal(u, v) for u, v in zip(
            fits[0]["params"], f["params"])) for f in fits[1:])
            and all(math.isfinite(v) for v in fits[0]["loss"])):
        raise AssertionError(f"{what}, (i) the CNF's fit: "
                             f"{[f['loss'] for f in fits]}")
    out["cnf_fit_s"] = fits[0]["s"]
    return out


def phase_mesh(device, n: int) -> dict:
    """The mesh (``aspire_tpu_torch.parallel``) on the card, ranks as
    ``spawn`` children of this script:

    (a) the reference: the mixture's pipeline at ``n`` in this process, no
    mesh, on the host ladder and the split route (``mesh_pipeline``; after
    a warm-up run, as every rank's runs), within the anchor's gate of the
    analytic log Z, 22 B1 a rung, 1 B3, no B2;
    (b) NCCL over every card of the machine, a child each (world size 1
    on a one-card machine; gloo on the CPU): for each of MESH_IMPLS the
    same run on the mesh, held by ``check_mesh_job``; at world size 1 the
    same bits as (a) (betas, log Z, population, generator state);
    (c) two ranks on the one card over gloo (asked for by name: NCCL takes
    one card a rank), n / 2 rows each, held by ``check_mesh_job``: both
    ranks the same bits; the overflow at the op level taking the ring and
    giving ``x[idx]``;
    (d) with (c) (and (b) on more than one card) the ranks' data-parallel
    ``Flow.fit``: the parameters the same bits on every rank, the loss
    falling;
    (e)-(i) in the same jobs (``check_mesh_slice_ii``): the device ladder
    on the mesh for each of MESH_IMPLS, its rung captured over NCCL and
    eager over gloo, against a one-process device-ladder reference (split
    route, captured) run here; the checkpointed runs (a checkpoint a rung
    on each ladder, in memory), their resume from rung MESH_RESUME_RUNG
    and the sample history's rows; ``emcee_smc`` and ``nuts_smc``; PT with
    its walkers sharded and the standalone tpCN; the CNF's data-parallel
    fit. Each reference runs here, in one process.
    With two cards or more, C18's check (``two_card_check``) runs here.
    Every job is joined within MESH_JOB_TIMEOUT_S; a rank that fails or
    hangs fails the phase. The gloo figures are gloo on one card, staged
    through the host: not NCCL's, and no scaling figure."""
    import torch

    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    if on_card:
        log(f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))} (a "
            "capture of collectives needs 2.9.6 or later)")
    p, asp = mesh_aspire(device)
    truth = p.true_log_evidence()
    mesh_pipeline(asp, n)  # the warm-up, as each rank's
    ref = mesh_pipeline(asp, n)
    check_result(ref.pop("post"), n, truth)
    out = {"n": n, "truth": truth, "reference": ref}
    if ref["routes"] != ["split"] or (on_card and (
            (ref["b1"], ref["b3"], ref["b2"])
            != ((CHAIN_STEPS + 2) * ref["rungs"], 1, 0))):
        raise AssertionError(f"the reference pipeline: {ref}")
    # The one-process references of (e)-(h).
    mesh_pipeline(asp, n, ladder=True)  # its capture
    refs = {"ladder": mesh_pipeline(asp, n, ladder=True)}
    check_result(refs["ladder"].pop("post"), n, truth)
    if refs["ladder"]["mode"] != ("captured" if on_card else "eager") or (
            on_card and (refs["ladder"]["b1"], refs["ladder"]["b3"],
                         refs["ladder"]["b2"], refs["ladder"]["replays"])
            != ((CHAIN_STEPS + 2) * refs["ladder"]["rungs"], 1, 0,
                refs["ladder"]["rungs"])):
        raise AssertionError(f"the device-ladder reference: "
                             f"{refs['ladder']}")
    refs["checkpointed"] = {
        name: mesh_checkpointed(asp, n // MESH_CK_PART, None, on)
        for name, on in (("host", False), ("device", True))}
    refs["moves"] = mesh_moves(asp, n // MESH_MOVES_PART)
    refs["pt"] = mesh_pt(asp)
    out["ladder_reference"] = refs["ladder"]
    out["a_s"] = time.perf_counter() - t0
    cards = torch.cuda.device_count() if on_card else 1
    if cards >= 2:
        t1 = time.perf_counter()
        out["two_card"] = two_card_check()
        out["two_card_s"] = time.perf_counter() - t1
    else:
        log("C18's two-card check (every wrapper on cuda:1 tensors while "
            "cuda:0 is current) needs two cards: this machine has "
            f"{cards}; not run")
    state = (asp.flow.params, asp.flow.data_transform)
    out["nccl"], out["b_s"] = mesh_job(cards, "nccl" if on_card else "gloo",
                                       state, n, device.type)
    check_mesh_job(out["nccl"], ref, truth, n, on_card, cards == 1,
                   f"NCCL at world size {cards}")
    out["nccl_ii"] = check_mesh_slice_ii(
        out["nccl"], refs, truth, n, on_card, cards == 1, on_card,
        f"NCCL at world size {cards}")
    out["gloo"], out["c_s"] = mesh_job(2, "gloo", state, n, device.type)
    check_mesh_job(out["gloo"], ref, truth, n, on_card, False,
                   "two gloo ranks")
    out["gloo_ii"] = check_mesh_slice_ii(out["gloo"], refs, truth, n,
                                         on_card, False, False,
                                         "two gloo ranks")
    for q in (*out["nccl"], *out["gloo"]):
        for run in (*q["runs"].values(), *q["ladder"].values()):
            del run["x"], run["generator"]
        q.get("dp_fit", {}).pop("params", None)
        for key in ("checkpointed", "moves", "pt"):
            q.pop(key)
        q["cnf_fit"].pop("params")
    del ref["x"], ref["generator"]
    del refs["ladder"]["x"], refs["ladder"]["generator"]
    return out


def report_mesh(card: str, mesh: dict, phase_s: float) -> None:
    """Print ``phase_mesh``'s results and its seconds, a line each."""
    ref, n = mesh["reference"], mesh["n"]

    def per_rung(run):
        return run["wall_s"] / max(run["rungs"], 1)

    def runs(ranks):
        return "; ".join(
            f"{impl} {per_rung(r):.4f} s a rung, log Z {r['log_z']:.4f} "
            f"+/- {r['log_z_err']:.4f} (bits as (a): betas "
            f"{r['beta_bits_as_reference']}, log Z "
            f"{r['log_z_bits_as_reference']}, population "
            f"{r['same_as_reference']}; tolerance {r['tolerance']:.4f}), "
            f"per rank B1 {[q['runs'][impl]['b1'] for q in ranks]} / B3 "
            f"{[q['runs'][impl]['b3'] for q in ranks]} / B2 "
            f"{[q['runs'][impl]['b2'] for q in ranks]} in {r['rungs']} "
            "rungs" for impl in MESH_IMPLS
            for r in (ranks[0]["runs"][impl],))

    def extras(ranks):
        if len(ranks) == 1:
            return ""
        fit = ranks[0]["dp_fit"]
        return (f"; overflow {ranks[0]['overflow']}; data-parallel "
                f"Flow.fit (nsf-tpu, 4000 rows, {MESH_DP_FIT}) "
                f"{fit['s']:.2f} s, loss {fit['loss'][0]:.4f} -> "
                f"{fit['loss'][-1]:.4f}, the same parameters on every rank")

    print(f"[{card}] mesh (a) one process, no mesh, n={n}, host ladder, "
          f"split route: log Z {ref['log_z']:.4f} +/- {ref['log_z_err']:.4f}"
          f" vs analytic {mesh['truth']:.4f}; {ref['rungs']} rungs, "
          f"{per_rung(ref):.4f} s a rung; B1 {ref['b1']}, B3 {ref['b3']}, "
          f"B2 {ref['b2']}; part {mesh['a_s']:.1f} s", flush=True)
    nccl, gloo = mesh["nccl"], mesh["gloo"]
    print(f"[{card}] mesh (b) {nccl[0]['mesh'][2]} at world size "
          f"{len(nccl)} (rank 0 {nccl[0]['mesh']}), {n // len(nccl)} rows "
          f"a rank: {runs(nccl)}{extras(nccl)}; part {mesh['b_s']:.1f} s",
          flush=True)
    print(f"[{card}] mesh (c, d) two ranks on one card over gloo (staged "
          f"through the host; not NCCL, no scaling figure), {n // 2} rows "
          f"a rank: {runs(gloo)}{extras(gloo)}; part {mesh['c_s']:.1f} s",
          flush=True)
    lref = mesh["ladder_reference"]
    print(f"[{card}] mesh (e) reference: one process, device ladder "
          f"({lref['mode']}), split route, n={n}: log Z "
          f"{lref['log_z']:.4f} +/- {lref['log_z_err']:.4f}; "
          f"{lref['rungs']} rungs, {per_rung(lref):.4f} s a rung, "
          f"{lref['replays']} replays; B1 {lref['b1']}, B3 {lref['b3']}, "
          f"B2 {lref['b2']}", flush=True)
    for label, ranks, held in (("NCCL", nccl, mesh["nccl_ii"]),
                               ("gloo", gloo, mesh["gloo_ii"])):
        q = ranks[0]
        ladder = "; ".join(
            f"{impl} {q['ladder'][impl]['mode']} "
            f"{per_rung(q['ladder'][impl]):.4f} s a rung, log Z "
            f"{q['ladder'][impl]['log_z']:.4f}, bits as reference "
            f"{held[f'e {impl}']['same_bits']}, per rank B1 "
            f"{[r['ladder'][impl]['b1'] for r in ranks]} / B3 "
            f"{[r['ladder'][impl]['b3'] for r in ranks]} / B2 "
            f"{[r['ladder'][impl]['b2'] for r in ranks]} in "
            f"{q['ladder'][impl]['rungs']} rungs, collectives "
            f"{q['ladder'][impl]['collectives']}" for impl in MESH_IMPLS)
        print(f"[{card}] mesh (e) {label} at world size {len(ranks)}: "
              f"{ladder}", flush=True)
        print(f"[{card}] mesh (f)-(i) {label} at world size {len(ranks)}: "
              f"{ {k: v for k, v in held.items() if k[0] in 'fmpc'} }; "
              f"(f) {q['f_s']:.1f} s, (g) {q['g_s']:.1f} s, (h) "
              f"{q['h_s']:.1f} s, (i) {q['cnf_fit']['s']:.1f} s, loss "
              f"{q['cnf_fit']['loss']}", flush=True)
    if "two_card" in mesh:
        print(f"[{card}] mesh C18 two-card check "
              f"({mesh['two_card_s']:.1f} s): {mesh['two_card']}",
              flush=True)
    print(f"[{card}] phase_mesh: {phase_s:.1f} s", flush=True)


def mesh_alone() -> dict:
    """``phase_mesh`` alone after the kernels' build, its lines printed;
    its seconds and each part's."""
    import torch

    from aspire_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    t0 = time.perf_counter()
    mesh = phase_mesh(torch.device("cuda"), N_PIPELINE)
    phase_s = time.perf_counter() - t0
    report_mesh(card_line(), mesh, phase_s)
    return {"phase_s": phase_s, **{k: mesh[k] for k in (
        "a_s", "b_s", "c_s")}}


#: ``benchmarks/validate.py``'s CNF rows (:370-440), in its order.
CNF_ROWS = ("gaussian", "mixture", "rosenbrock", "funnel")
#: Their flow, ``Aspire(flow_matching=True, n_steps=64, seed=1)`` (the
#: velocity field at its default width, (128, 128, 128)), and its fit.
CNF_FLOW = dict(flow_matching=True, n_steps=64, seed=1)
CNF_FIT = dict(n_epochs=120, batch_size=512)
#: The importance rows' efficiency floor (``run_gate``'s ``eff_floor``).
CNF_EFF_FLOOR = 0.01
#: The CNF pipeline's chain, cut in depth from the rows' 20 steps for the
#: script's time (a 20-step run at n = 131072 took 84-88 s on the H100, a
#: 5-step run 24.7-26.5 s).
CNF_PIPELINE_STEPS = 3
#: The card-against-CPU check's n: the CPU's passes (float32 and float64)
#: at full width take tens of seconds at 16384.
CNF_CHECK_N = 2048
#: The inner flow's training at every fit of a flow preconditioning.
FLOW_PRECOND_FIT = dict(n_epochs=10, batch_size=1024)
#: The standalone samplers on the bounded Gaussian: steps and burn-in.
MCMC_RUNS = {
    "minipcn tpcn": dict(sampler="minipcn", step_fn="tpcn", n_steps=100,
                         burn_in=50),
    "minipcn pcn": dict(sampler="minipcn", step_fn="pcn", n_steps=100,
                        burn_in=50),
    "emcee": dict(sampler="emcee", n_steps=300, burn_in=150),
    "minipcn tpcn, flow preconditioning": dict(
        sampler="minipcn", step_fn="tpcn", n_steps=100, burn_in=50,
        preconditioning="flow",
        preconditioning_kwargs=dict(fit_kwargs=FLOW_PRECOND_FIT)),
}


def mixture_truth(p) -> float:
    """log Z of ``GaussianMixtureProblem``: ``benchmarks/validate.py::
    analytic_log_z``'s closed form, copied (each component convolved with
    the N(0, I) prior)."""
    import numpy as np

    def comp(mu, var):
        d = len(mu)
        return (-0.5 * d * np.log(2 * np.pi * (1 + var))
                - 0.5 * mu @ mu / (1 + var))

    return float(np.logaddexp(comp(p.mu1, p.var1), comp(p.mu2, p.var2))
                 - np.log(2.0))


def sampling_launches() -> int:
    """B3's launches alone (the coupling kernel in sampling mode)."""
    from aspire_tpu_torch.ops import fused_coupling as FC

    return FC.sampling_launches.count


def cnf_row(device, row: str):
    """A CNF row as ``benchmarks/validate.py`` runs it: the problem on its
    prior bounds, 8192 fit draws of ``default_rng(0)`` (the Gaussian's
    N(1, 1.2), the others' own initial draws), the truth; the CNF
    (``CNF_FLOW``) fitted by ``CNF_FIT``. Returns ``(problem, aspire,
    truth, fit seconds)``."""
    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import (
        FunnelProblem,
        GaussianMixtureProblem,
        GaussianProblem,
        RosenbrockProblem,
    )

    rng = np.random.default_rng(0)
    if row == "gaussian":
        p = GaussianProblem(dims=4)
        x, truth = rng.normal(1.0, 1.2, size=(8192, 4)), p.true_log_evidence
    else:
        p = {"mixture": lambda: GaussianMixtureProblem(dims=4),
             "rosenbrock": lambda: RosenbrockProblem(dims=2),
             "funnel": lambda: FunnelProblem(dims=5)}[row]()
        x = p.draw_initial_samples(rng, 8192)
        truth = {"mixture": lambda: mixture_truth(p),
                 "rosenbrock": lambda: rosenbrock_truth(p.lower, p.upper),
                 "funnel": lambda: funnel_truth(p.dims, p.scale,
                                                p.prior_scale)}[row]()
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=p.dims, prior_bounds=p.prior_bounds, device=device,
                 **CNF_FLOW)
    t0 = time.perf_counter()
    asp.fit(Samples(x), **CNF_FIT)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return p, asp, truth, time.perf_counter() - t0


def cnf_gate(asp, sampler: str, n: int, truth: float,
             informational: bool = False, **kwargs) -> dict:
    """One CNF row: ``sampler`` at n on ``asp``'s default path, held by
    ``run_gate``'s rule (|log Z - truth| < max(5 sigma, 0.02); an
    importance row also an efficiency of at least ``CNF_EFF_FLOOR``),
    unless ``informational``. No kernel runs (the CNF has none); an SMC
    row's mutations take the split chain."""
    import torch

    on_card = asp.device.type == "cuda"
    reset_launch_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if sampler != "importance":
        kwargs["store_sample_history"] = False
    post = asp.sample_posterior(sampler=sampler, n_samples=n, **kwargs)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lz, err = float(post.log_evidence), float(post.log_evidence_error)
    tol = max(5 * err, 0.02)
    out = {"sampler": sampler, "log_z": lz, "log_z_err": err,
           "truth": truth, "tolerance": tol, "wall_s": wall,
           "launches": launch_counts()}
    ok = abs(lz - truth) < tol
    if sampler == "importance":
        out["efficiency"] = float(post.efficiency)
        ok = ok and out["efficiency"] >= CNF_EFF_FLOOR
    else:
        sampler_ = asp.sampler
        routes = sampler_.history.mutation_route
        out.update(rungs=len(sampler_.history.beta),
                   routes=sorted(set(routes)),
                   ladder="device" if sampler_.ladder is not None
                   else "host")
        if sampler_.ladder is not None:
            out["capture_s"] = sampler_.ladder.capture_s
        if set(routes) != {"split"}:
            raise AssertionError(f"CNF mutations off the split chain: "
                                 f"{routes}")
    out["ok"] = ok
    if informational:
        out["informational"] = True
    log(f"CNF {sampler} at n={n}: {out}")
    if tuple(post.x.shape) != (n, asp.dims) or not bool(
            torch.isfinite(post.x).all()):
        raise AssertionError("CNF posterior samples are not finite")
    if any(out["launches"].values()):
        raise AssertionError(f"a kernel ran for the CNF: {out['launches']}")
    if not ok and not informational:
        raise AssertionError(f"CNF {sampler} row off its gate: {out}")
    return out


def cnf_device_check(device, n: int, dims: int = 4,
                     n_hidden=(128, 128, 128), n_steps: int = 64) -> dict:
    """The CNF's density and sampling passes on ``device`` against the
    same flow on the CPU (float32, TF32 off; weights perturbed by 0.1 from
    seed 4 so the field is not the identity) at n, with float64 on the CPU
    beside: the two within 1e-4, or the device at most twice as far from
    float64 as the CPU. The device's seconds for each pass after a warm-up
    call (host clock to a synchronize)."""
    import numpy as np
    import torch

    from aspire_tpu_torch.flows import FlowMatching
    from aspire_tpu_torch.flows.train import param_leaves

    exact = FlowMatching(dims, seed=3, device="cpu", dtype="float64",
                         n_hidden=n_hidden, n_steps=n_steps)
    g = torch.Generator().manual_seed(4)
    for leaf in param_leaves(exact.params):
        leaf.add_(0.1 * torch.randn(leaf.shape, generator=g,
                                    dtype=torch.float64))

    def flow(dev):
        f = FlowMatching(dims, device=dev, n_hidden=n_hidden,
                         n_steps=n_steps)
        for leaf, src in zip(param_leaves(f.params),
                             param_leaves(exact.params)):
            leaf.copy_(src)
        return f

    x = torch.as_tensor(np.random.default_rng(5).normal(size=(n, dims)))
    out = {"n": n, "dims": dims, "n_hidden": list(n_hidden),
           "n_steps": n_steps}
    cpu, dev = flow("cpu"), flow(device)
    with torch.no_grad():
        for name, fn in (("log_prob", lambda f, v: f.log_prob(v)),
                         ("inverse", lambda f, v: f.inverse(v)[1])):
            want = fn(exact, x)
            plain = fn(cpu, x.float()).double()
            fn(dev, x.float().to(device))
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = fn(dev, x.float().to(device))
            if device.type == "cuda":
                torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            got = got.double().cpu()
            out[f"{name}_max_abs_diff_cpu"] = float((got - plain).abs().max())
            out[f"{name}_max_abs_err_f64"] = float((got - want).abs().max())
            out[f"{name}_cpu_max_abs_err_f64"] = float(
                (plain - want).abs().max())
            if not (out[f"{name}_max_abs_diff_cpu"] <= 1e-4 or out[
                    f"{name}_max_abs_err_f64"] <= 2 * out[
                    f"{name}_cpu_max_abs_err_f64"]):
                raise AssertionError(f"CNF {name} on {device} against the "
                                     f"CPU: {out}")
    log(f"CNF on {device} against the CPU: {out}")
    return out


def cnf_pass_times(asp, n: int) -> dict:
    """Seconds of one density pass (``log_prob``) and one sampling pass
    (``sample_and_log_prob``) of ``asp``'s CNF at n, each after a warm-up
    call (host clock to a synchronize)."""
    import numpy as np
    import torch

    x = torch.as_tensor(np.random.default_rng(6).normal(size=(n, asp.dims)),
                        dtype=torch.float32, device=asp.device)
    out = {"n": n}

    def sync():
        if x.is_cuda:
            torch.cuda.synchronize(x.device)

    for name, fn in (("log_prob_s", lambda: asp.flow.log_prob(x)),
                     ("sample_s", lambda: asp.flow.sample_and_log_prob(n))):
        with torch.no_grad():
            fn()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
        out[name] = time.perf_counter() - t0
    log(f"CNF passes at n={n}: {out}")
    return out


def phase_cnf(device, n_anchor: int, n_pipeline: int) -> dict:
    """The flow-matching CNF (``flows/matching.py``, plain torch: the JAX
    package runs it on XLA with no Pallas kernel):

    (a) its density and sampling passes on the card against the CPU at
    CNF_CHECK_N (``cnf_device_check``);
    (b) ``benchmarks/validate.py``'s 8 CNF rows (``CNF_ROWS``), each
    problem's CNF fitted as the script fits it (``cnf_row``): importance
    and SMC with 20-step tpCN at ``n_anchor``, gated by ``cnf_gate``; the
    mixture's importance row informational, as the script records it;
    (c) the mixture's CNF at ``n_pipeline``: one density and one
    sampling pass timed (``cnf_pass_times``); its SMC with
    CNF_PIPELINE_STEPS-step tpCN on the device ladder (the default path;
    one CUDA graph a rung of (CNF_PIPELINE_STEPS + 2) x 64 x 4 velocity
    evaluations) in turns with the host ladder (``ladder_turns``: device,
    host, device; the second device run replays once per rung): one
    population for both, their log Z within max(5 combined sigma, 0.15);
    the capture's seconds, and the kernels one replay runs (read by the
    profiler at the end of the run, ``replay_kernels``).
    """
    on_card = device.type == "cuda"
    out = {"device_check": cnf_device_check(device, CNF_CHECK_N),
           "rows": {}}
    mixture = None
    for row in CNF_ROWS:
        p, asp, truth, fit_s = cnf_row(device, row)
        out["rows"][row] = {
            "fit_s": fit_s, "dims": p.dims,
            "importance": cnf_gate(asp, "importance", n_anchor, truth,
                                   informational=row == "mixture"),
            "smc": cnf_gate(asp, "smc", n_anchor, truth,
                            sampler_kwargs=dict(n_steps=CHAIN_STEPS))}
        if row == "mixture":
            mixture = asp
    out["pass_times"] = cnf_pass_times(mixture, n_pipeline)
    pipeline = dict(sampler="smc", n_samples=n_pipeline,
                    store_sample_history=False,
                    sampler_kwargs=dict(n_steps=CNF_PIPELINE_STEPS))
    ladders = ladder_turns(mixture, pipeline, {}, warm=False,
                           turns=("device", "host", "device"))
    out["pipeline"] = ladders
    if on_card:
        if not ladders["ladders_agree_bitwise"]:
            raise AssertionError(f"CNF pipeline: the ladders gave two "
                                 f"populations: {ladders}")
        (_, lad), = mixture.ladder_cache.values()
        _KERNEL_MS_LATER.append(lambda: ladders.update(replay_kernels(lad)))
    return out


def flow_preconditioned_anchor(asp, n: int, truth: float, inner: str
                               ) -> dict:
    """SMC with ``preconditioning="flow"`` at n on ``asp`` (nsf-tpu on the
    mixture), 20-step tpCN, the inner flow refitted at every mutation by
    ``FLOW_PRECOND_FIT``: nsf-tpu (the Aspire's own backend) or a CNF
    (``flow_matching=True``, default width). Every mutation on the split
    route, the host ladder (the device ladder refuses a preconditioning),
    log Z within max(5 sigma, 0.02) of the truth; on the card B1 and B3
    counted a rung: with nsf-tpu inside at least CHAIN_STEPS + 1 B3 (the
    preconditioning's inverse at the chain's start and every step)."""
    import torch

    kwargs = dict(fit_kwargs=FLOW_PRECOND_FIT)
    if inner == "cnf":
        kwargs["flow_matching"] = True
    on_card = asp.device.type == "cuda"
    reset_launch_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = asp.sample_posterior(
        sampler="smc", n_samples=n, store_sample_history=False,
        preconditioning="flow", preconditioning_kwargs=kwargs,
        sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampler = asp.sampler
    routes = sampler.history.mutation_route
    launches = launch_counts()
    b3 = sampling_launches()
    rungs = len(routes)
    out = {"inner": inner, "fit_kwargs": FLOW_PRECOND_FIT,
           "log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
           "truth": truth, "wall_s": wall, "rungs": rungs,
           "routes": sorted(set(routes)),
           "ladder": "device" if sampler.ladder is not None else "host",
           "b1": launches["coupling"] - b3, "b3": b3,
           "b1_per_rung": (launches["coupling"] - b3) / max(rungs, 1),
           "b3_per_rung": b3 / max(rungs, 1),
           "chain_launches": launches["chain"]}
    log(f"flow preconditioning ({inner} inside) at n={n}: {out}")
    if set(routes) != {"split"} or out["ladder"] != "host":
        raise AssertionError(f"flow preconditioning left the split route or "
                             f"took the device ladder: {out}")
    if on_card and (launches["chain"] or out["b1"] < (CHAIN_STEPS + 2)
                    * rungs or (inner == "nsf-tpu"
                                and b3 < (CHAIN_STEPS + 1) * rungs)):
        raise AssertionError(f"flow preconditioning's launches: {out}")
    check_result(post, n, truth, asp.dims)
    return out


def phase_flow_preconditioning(device, n: int) -> dict:
    """``preconditioning="flow"`` (``FlowPreconditioningTransform``) on
    the 4-d mixture fitted as the validation rows are (``mixture_aspire``):
    SMC at n with nsf-tpu inside (B3 in every chain step) and with a CNF
    inside (``flow_preconditioned_anchor``), each against -9.3709 (the
    analytic log Z); ``device_ladder=True`` refused."""
    p, asp = mixture_aspire(device)
    truth = p.true_log_evidence()
    out = {inner: flow_preconditioned_anchor(asp, n, truth, inner)
           for inner in ("nsf-tpu", "cnf")}
    try:
        asp.sample_posterior(sampler="smc", n_samples=n, device_ladder=True,
                             preconditioning="flow",
                             sampler_kwargs=dict(n_steps=CHAIN_STEPS))
        raise AssertionError("device_ladder=True ran a flow preconditioning")
    except ValueError as err:
        out["device_ladder"] = str(err)
    return out


def mcmc_run(asp, walkers: int, run: dict) -> dict:
    """One standalone sampler on ``asp`` (the bounded Gaussian): its
    acceptance, autocorrelation time, seconds and launches, and the gate:
    each dimension's mean within max(5 SE, 0.02) of 2 and sd within
    max(5 SE / sqrt 2, 0.02) of 1, SE = sd / sqrt(N_eff), N_eff = walkers x
    kept steps / tau."""
    import numpy as np
    import torch

    on_card = asp.device.type == "cuda"
    reset_launch_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = asp.sample_posterior(n_samples=walkers, **run)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tau = samples.compute_autocorrelation_time().numpy()
    kept = samples.chain_shape[0]
    x = samples.x.double()
    mean, sd = x.mean(0).cpu().numpy(), x.std(0).cpu().numpy()
    se = sd * np.sqrt(tau / (walkers * kept))
    launches = launch_counts()
    out = {"n_steps": run["n_steps"], "burn_in": run["burn_in"],
           "walkers": walkers, "kept_steps": kept,
           "acceptance": samples.acceptance_rate, "tau": tau.tolist(),
           "mean": mean.tolist(), "sd": sd.tolist(), "se": se.tolist(),
           "wall_s": wall, "launches": launches, "b3": sampling_launches(),
           "evaluations": asp.sampler.n_likelihood_evaluations}
    ok = (np.all(np.isfinite(tau)) and np.all(np.abs(mean - 2.0) < np.maximum(
        5 * se, 0.02)) and np.all(np.abs(sd - 1.0) < np.maximum(
            5 * se / math.sqrt(2), 0.02)))
    log(f"{run['sampler']} {run.get('step_fn', '')} "
        f"{run.get('preconditioning', '')}: {out}")
    if not ok:
        raise AssertionError(f"standalone sampler off its moments: {out}")
    return out


def phase_mcmc(device, walkers: int) -> dict:
    """The standalone samplers (``samplers/mcmc.py``) on the bounded 4-d
    Gaussian of ``phase_bounded_path`` (``bounded_aspire``): each of
    ``MCMC_RUNS`` with ``walkers`` walkers held by ``mcmc_run``; the
    flow-preconditioned run inverts its nsf-tpu in every step (B3, at
    least n_steps + 1 launches, and once over the whole chain)."""
    _, asp = bounded_aspire(device)
    out = {name: mcmc_run(asp, walkers, run)
           for name, run in MCMC_RUNS.items()}
    flow_run = out["minipcn tpcn, flow preconditioning"]
    if device.type == "cuda" and flow_run["b3"] < flow_run["n_steps"] + 2:
        raise AssertionError(f"the flow-preconditioned chain's B3 "
                             f"launches: {flow_run}")
    return out


#: The validation's PT rows (``benchmarks/validate.py:52-76``): its PT
#: kwargs verbatim, at its walker count n // 32; the funnel on three fits.
PT_ROWS = ("gaussian", "mixture", "rosenbrock", "funnel")
PT_KWARGS = dict(n_steps=800, n_temperatures=12, betas="adaptive",
                 swap_every=5, ladder_pilot_steps=40,
                 ladder_pilot_iterations=2)
PT_WALKERS = N_VALIDATE // 32
#: The card against the CPU in float64: geometric rungs, walkers, rounds.
PT_CHECK = dict(n_temps=4, n=1024, rounds=8, swap_every=2)
PT_CHECK_TOL = 1e-9
#: Flow-preconditioned PT on the bounded Gaussian: each half-move inverts
#: T x n / 2 = 4096 states (one B3 launch).
PT_FLOW = dict(n_temperatures=8, n_samples=1024, n_steps=50, swap_every=1)
#: The rounds of the timed run on each row's ladder (seconds a round).
PT_TIMED_ROUNDS = 20


@contextlib.contextmanager
def pt_draw_stream(record: list | None = None, replay: list | None = None,
                   device=None):
    """The samplers' draw functions (``kernels._randint``, ``_uniform``)
    recording each draw into ``record``, or returning ``replay``'s draws in
    order, moved to ``device``."""
    from aspire_tpu_torch.samplers import kernels as K

    saved = K._randint, K._uniform

    def wrap(fn):
        def draw(*args):
            if replay is not None:
                return replay.pop(0).to(device)
            v = fn(*args)
            record.append(v.clone())
            return v
        return draw

    K._randint, K._uniform = wrap(saved[0]), wrap(saved[1])
    try:
        yield
    finally:
        K._randint, K._uniform = saved


def max_diff(a, b) -> float:
    """Largest |a - b| over two tensors or arrays, equal infinities and
    NaNs counting 0 and any other non-finite mismatch infinity."""
    import torch

    a, b = (torch.as_tensor(v).detach().double().cpu() for v in (a, b))
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    if not bool((same | (torch.isfinite(a) & torch.isfinite(b))).all()):
        return math.inf
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    return float(diff.max()) if diff.numel() else 0.0


def pt_device_check(device) -> dict:
    """``PT_CHECK``'s run on the bounded Gaussian (``GaussianProblem(
    dims=4)``), float64, from one numpy seed's initial states, on the CPU
    and then on ``device`` with the CPU run's draws replayed
    (``pt_draw_stream``): chain, logL, logPi and both acceptances within
    PT_CHECK_TOL."""
    import numpy as np
    import torch

    from aspire_tpu_torch.models import GaussianProblem
    from aspire_tpu_torch.samplers import ParallelTemperedSampler

    c = PT_CHECK
    p = GaussianProblem(dims=4)
    x0 = np.random.default_rng(7).uniform(-3.0, 7.0,
                                          size=(c["n_temps"] * c["n"], 4))
    betas = np.concatenate([0.5 ** np.arange(c["n_temps"] - 1), [0.0]])

    def run(dev, **stream):
        sampler = ParallelTemperedSampler(
            p.log_likelihood, p.log_prior, 4, prior_flow=None,
            dtype="float64", device=dev, rng=7)
        with pt_draw_stream(**stream):
            return sampler.sample(c["n"], n_steps=c["rounds"]
                                  * c["swap_every"], betas=betas,
                                  swap_every=c["swap_every"], _init_x=x0)

    draws = []
    cpu = run(torch.device("cpu"), record=draws)
    out = {**c, "draws": len(draws)}
    card = run(device, replay=draws, device=device)
    if draws:
        raise AssertionError(f"the card's run left {len(draws)} draws")
    out["max_abs_diff"] = {
        "chain": max_diff(card.chain, cpu.chain),
        **{k: max_diff(getattr(card, k), getattr(cpu, k))
           for k in ("log_likelihood", "log_prior", "move_acceptance",
                     "swap_acceptance")}}
    out["move_acceptance"] = cpu.move_acceptance.tolist()
    out["swap_acceptance"] = cpu.swap_acceptance.tolist()
    log(f"PT on the card against the CPU, float64: {out}")
    if not all(v <= PT_CHECK_TOL for v in out["max_abs_diff"].values()):
        raise AssertionError(f"PT: the card's run left the CPU's: {out}")
    return out


def pt_continue(sampler, post, rounds: int):
    """``rounds`` more rounds of ``post``'s run (its ladder, walkers and
    ``PT_KWARGS``'s swap_every) from its final states."""
    se = PT_KWARGS["swap_every"]
    n = post.chain_shape[2]
    return sampler.sample(n, n_steps=rounds * se, betas=post.betas,
                          swap_every=se,
                          _init_x=post.chain[:, -1].reshape(-1, post.dims))


def pt_round_kernels(sampler, post) -> dict:
    """The device operations (kernels, copies, fills) of one PT round on
    ``post``'s ladder and their device time: ``torch.profiler``'s CUDA
    activity over a 2-round run less that over a 1-round run, which share
    everything else."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts, us = [], []
    for rounds in (1, 2):
        for attempt in range(3):  # a trace can come back without the card's
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                pt_continue(sampler, post, rounds)
                torch.cuda.synchronize()
            ops = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
            if ops:
                break
            log(f"the profiler recorded no PT kernel (trace {attempt})")
        counts.append(sum(e.count for e in ops))
        us.append(sum(getattr(e, "device_time_total", 0) for e in ops))
    return {"ops": counts[1] - counts[0], "device_ms": (us[1] - us[0]) / 1e3}


def pt_row(asp, truth: float, profile_round: bool) -> dict:
    """One PT row: ``sample_posterior(sampler="ptmcmc", PT_WALKERS walkers,
    store_sample_history=False, **PT_KWARGS)`` on ``asp`` (the
    validation's own call), timed; its stepping-stone and TI ("total") log
    Z, rungs, acceptances, evaluations, rounds, B3 launches; then
    PT_TIMED_ROUNDS more rounds timed (seconds a round) and, with
    ``profile_round``, the device operations of one round and their
    device time noted for the end of the run (``pt_round_kernels``)."""
    import numpy as np
    import torch

    on_card = asp.device.type == "cuda"
    reset_launch_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = asp.sample_posterior(sampler="ptmcmc", n_samples=PT_WALKERS,
                                store_sample_history=False, **PT_KWARGS)
    if on_card:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sampler = asp.sampler
    out = {"walkers": PT_WALKERS, "wall_s": wall,
           "evaluations": sampler.n_likelihood_evaluations,
           "rounds": post.chain_shape[1], "rungs": len(post.betas),
           "betas": np.asarray(post.betas).tolist(),
           "b3": sampling_launches(), "launches": launch_counts(),
           "move_acceptance_mean": float(np.mean(post.move_acceptance)),
           "swap_acceptance_min": float(np.min(post.swap_acceptance)),
           "truth": truth}
    out["log_z"], out["log_z_err"] = post.log_evidence_stepping_stone()
    out["ti_log_z"], out["ti_err"] = (
        post.log_evidence_thermodynamic_integration(method="total"))
    x = post.cold_chain().x
    if not (bool(torch.isfinite(x).all()) and math.isfinite(out["log_z"])
            and math.isfinite(out["log_z_err"])):
        raise AssertionError(f"PT samples or log Z not finite: {out}")
    if on_card and out["b3"] < 1:
        raise AssertionError(f"the PT probe took no B3 launch: {out}")
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt_continue(sampler, post, PT_TIMED_ROUNDS)
    if on_card:
        torch.cuda.synchronize()
    out["s_per_round"] = (time.perf_counter() - t0) / PT_TIMED_ROUNDS
    if on_card and profile_round:
        _KERNEL_MS_LATER.append(lambda: out.__setitem__(
            "round_profile", pt_round_kernels(sampler, post)))
    return out


def pt_flow_preconditioned(device) -> dict:
    """``PT_FLOW`` on the bounded Gaussian (``bounded_aspire``) with
    ``preconditioning="flow"`` (nsf-tpu inside, ``FLOW_PRECOND_FIT``): B3
    at least twice a move (each half-move's inverse), the stepping-stone
    log Z printed beside the truth, not gated."""
    import torch

    p, asp = bounded_aspire(device)
    on_card = device.type == "cuda"
    reset_launch_counts()
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post = asp.sample_posterior(
        sampler="ptmcmc", preconditioning="flow",
        preconditioning_kwargs=dict(fit_kwargs=FLOW_PRECOND_FIT), **PT_FLOW)
    if on_card:
        torch.cuda.synchronize()
    out = {**PT_FLOW, "wall_s": time.perf_counter() - t0,
           "b3": sampling_launches(), "launches": launch_counts(),
           "truth": p.true_log_evidence}
    out["log_z"], out["log_z_err"] = post.log_evidence_stepping_stone()
    log(f"PT with preconditioning=\"flow\": {out}")
    if not bool(torch.isfinite(post.x).all()) or (
            on_card and out["b3"] < 2 * PT_FLOW["n_steps"]):
        raise AssertionError(f"flow-preconditioned PT: {out}")
    return out


def phase_ptmcmc(device, n_smc: int) -> dict:
    """The parallel-tempered sampler (``samplers/mcmc.py``:
    ``ParallelTemperedSampler``, ``PTMCMCSamples``) and the replicate tier:

    (a) ``pt_device_check``: the card against the CPU in float64;
    (b) the validation's PT rows (``PT_ROWS``, ``pt_row``), each fitted as
    ``validate_aspire`` fits it, the stepping-stone log Z within max(5
    sigma, 0.02) of the truth (``benchmarks/validate.py``'s gate), the
    funnel's three fits (seeds 1-3) combined by ``combined_log_z``;
    (c) ``pt_flow_preconditioned``;
    (d) SMC with ``n_replicates=3`` on the mixture row's fit at ``n_smc``
    (20-step tpCN), the replicates' log Z in the same gate.
    """
    import numpy as np

    from aspire_tpu_torch.models import GaussianMixtureProblem, GaussianProblem

    out = {"device_check": pt_device_check(device), "rows": {}}
    truths = {"gaussian": GaussianProblem(dims=4).true_log_evidence,
              "mixture": mixture_truth(GaussianMixtureProblem(dims=4)),
              "rosenbrock": rosenbrock_truth(), "funnel": funnel_truth()}
    fits = {}
    for row in PT_ROWS:
        runs = []
        for seed in ((1, 2, 3) if row == "funnel" else (1,)):
            _, asp = validate_aspire(device, row, seed)
            fits.setdefault(row, asp)
            runs.append(pt_row(asp, truths[row], profile_round=seed == 1))
        log_z, err = (combined_log_z([r["log_z"] for r in runs],
                                     [r["log_z_err"] for r in runs],
                                     f"{row} PT") if len(runs) > 1 else
                      (runs[0]["log_z"], runs[0]["log_z_err"]))
        v = {"log_z": log_z, "log_z_err": err, "truth": truths[row],
             "runs": runs}
        out["rows"][row] = v
        log(f"{row} PT row, {PT_WALKERS} walkers: {v}")
        if not abs(log_z - truths[row]) < max(5 * err, 0.02):
            raise AssertionError(f"{row} PT row off the truth: {v}")
    out["flow"] = pt_flow_preconditioned(device)

    asp = fits["mixture"]
    t0 = time.perf_counter()
    post = asp.sample_posterior(sampler="smc", n_samples=n_smc,
                                n_replicates=3, store_sample_history=False,
                                sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    v = {"log_z": post.log_evidence, "log_z_err": post.log_evidence_error,
         "replicates": np.asarray(post.log_evidence_replicates).tolist(),
         "single_run_err": post.log_evidence_error_single,
         "wall_s": time.perf_counter() - t0, "truth": truths["mixture"]}
    out["smc_replicates"] = v
    log(f"SMC with n_replicates=3 on the mixture, n={n_smc}: {v}")
    if len(v["replicates"]) != 3 or not abs(
            v["log_z"] - v["truth"]) < max(5 * v["log_z_err"], 0.02):
        raise AssertionError(f"SMC replicate tier off the truth: {v}")
    return out


#: the histories a checkpoint's must match bit for bit
CHECKPOINT_HISTORY = ("beta", "ess", "ess_target", "eff_target",
                      "log_norm_ratio", "log_norm_ratio_var",
                      "mcmc_acceptance", "mcmc_autocorr", "lineage_fraction",
                      "mutation_route", "nonfinite_target")


def checkpoint_run(asp, run: dict, callback=None, states: bool = False,
                   **kw) -> dict:
    """One ``sample_posterior`` of ``run`` on ``asp`` with the launch counts
    set to 0 just before it and read just after; its checkpoint states go
    to ``callback``, or with ``states`` into the result (in memory)."""
    import torch

    states = [] if states else None
    if states is not None:
        callback = states.append
    replays = {id(v[1]): v[1].replays for v in asp.ladder_cache.values()}
    reset_launch_counts()
    on_card = asp.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    post, hist = asp.sample_posterior(
        **run, return_history=True,
        checkpoint_callback=callback, **kw)
    if on_card:
        torch.cuda.synchronize()
    lad = asp.sampler.ladder
    return {"post": post, "hist": hist, "states": states,
            "wall_s": time.perf_counter() - t0, "launches": launch_counts(),
            "ladder": lad,
            "replayed": (lad.replays - replays[id(lad)]
                         if lad is not None and id(lad) in replays else None)}


def same_checkpoint(a: dict, b: dict) -> bool:
    """Two checkpoint states the same bits (its config aside)."""
    import numpy as np

    if set(a) != set(b):
        return False
    for key in a:
        va, vb = a[key], b[key]
        if key == "config":
            continue
        if key == "samples":
            if va.beta != vb.beta or not all(np.array_equal(
                    getattr(va, f), getattr(vb, f)) for f in (
                        "x", "log_likelihood", "log_prior", "log_q")):
                return False
        elif key == "history":
            if any(getattr(va, f) != getattr(vb, f)
                   for f in CHECKPOINT_HISTORY):
                return False
        elif isinstance(va, np.ndarray):
            if not np.array_equal(va, vb):
                return False
        elif va != vb:
            return False
    return True


def checkpoint_checks(asp, run: dict, need: dict,
                      truth: float | None = None) -> dict:
    """The device ladder's checkpoint on ``run`` (the default path, its rung
    replayed from the ladder cache): (1) a run with every rung's state
    handed to a callback against a run without, the same bits (population,
    log Z, history), the same launches (``need`` a rung at least, each
    kernel of the path launched), the ladder replayed once per rung and
    never captured again; (2) the middle state's bytes resumed on the device
    ladder and on the host ladder: one population, the state's history as
    the prefix, beta 1 (and ``check_result`` against ``truth``); (3) the last
    state (beta 1) resumed: no rung runs, no kernel launches."""
    import torch

    from aspire_tpu_torch.io import load_pickle
    from aspire_tpu_torch.samplers.base import Sampler

    checkpoint_run(asp, run, device_ladder=True)  # captures if not cached
    off = checkpoint_run(asp, run, device_ladder=True)
    on = checkpoint_run(asp, run, device_ladder=True, states=True)
    on_card = asp.device.type == "cuda"
    rungs = len(off["hist"].beta)
    per_rung = {k: v / rungs for k, v in on["launches"].items()}
    out = {"rungs": rungs, "states": len(on["states"]),
           "launches_off": off["launches"], "launches_on": on["launches"],
           "same_bits": torch.equal(on["post"].x, off["post"].x)
           and on["post"].log_evidence == off["post"].log_evidence
           and all(getattr(on["hist"], f) == getattr(off["hist"], f)
                   for f in CHECKPOINT_HISTORY),
           "replays": [off["replayed"], on["replayed"]],
           "one_ladder": on["ladder"] is off["ladder"]}
    log(f"checkpoints on vs off: {out}")
    if not out["same_bits"] or on["launches"] != off["launches"]:
        raise AssertionError(f"checkpoints changed the run: {out}")
    if [s["iteration"] for s in on["states"]] != [*range(1, rungs + 1),
                                                  rungs]:
        raise AssertionError("a rung's checkpoint is missing: "
                             f"{[s['iteration'] for s in on['states']]}")
    if on_card and (out["replays"] != [rungs, rungs] or not out["one_ladder"]
                    or any(on["launches"][k] < v * rungs
                           for k, v in need.items())):
        raise AssertionError(f"the ladder's graph did not replay once a rung "
                             f"with {need} launches a rung: {out}")
    out["launches_per_rung"] = per_rung
    if any(isinstance(v, torch.Tensor) for state in on["states"]
           for v in (*state.values(), *vars(state["samples"]).values())):
        raise AssertionError("a checkpoint state holds a tensor")
    # The host ladder's states at the same rungs (reported: the CPU tests
    # hold the two ladders' states to the same bits).
    host = checkpoint_run(asp, run, device_ladder=False, states=True)
    out["host_ladder_states_same_bits"] = len(host["states"]) == len(
        on["states"]) and all(same_checkpoint(a, b) for a, b in zip(
            host["states"], on["states"]))

    mid_state = on["states"][rungs // 2 - 1]
    mid = Sampler.serialize_checkpoint_state(mid_state)
    prefix = load_pickle(mid)["history"]
    k = len(prefix.beta)
    resumed = {}
    for ladder in (True, False):
        r = checkpoint_run(asp, run, device_ladder=ladder, resume_from=mid)
        hist = r["hist"]
        if any(getattr(hist, f)[:k] != getattr(prefix, f)
               for f in CHECKPOINT_HISTORY) or hist.beta[-1] != 1.0:
            which = "device" if ladder else "host"
            raise AssertionError(f"resumed run ({which} ladder) lost the "
                                 "checkpoint's history or stopped short of "
                                 "beta 1")
        if truth is not None:
            check_result(r["post"], run["n_samples"], truth, asp.dims)
        resumed["device" if ladder else "host"] = r
    rd, rh = resumed["device"], resumed["host"]
    out["resume"] = {
        "from_iteration": mid_state["iteration"], "bytes": len(mid),
        "rungs": len(rd["hist"].beta), "ladders_same_bits": torch.equal(
            rd["post"].x, rh["post"].x),
        "log_z": rd["post"].log_evidence,
        "log_z_err": rd["post"].log_evidence_error,
        "host_log_z": rh["post"].log_evidence,
        "launches": rd["launches"], "host_launches": rh["launches"],
        "replayed": rd["replayed"]}
    log(f"resumed from rung {mid_state['iteration']}: {out['resume']}")
    if not out["resume"]["ladders_same_bits"]:
        raise AssertionError("the two ladders resumed one checkpoint into "
                             "different populations")
    last = checkpoint_run(asp, run, device_ladder=True,
                          resume_from=Sampler.serialize_checkpoint_state(
                              on["states"][-1]))
    out["resume_last"] = {"rungs": len(last["hist"].beta),
                          "launches": last["launches"],
                          "ladder": last["ladder"] is not None}
    log(f"resumed from the last state: {out['resume_last']}")
    if (len(last["hist"].beta) != rungs or last["ladder"] is not None
            or any(last["launches"].values())):
        raise AssertionError(f"a completed checkpoint ran the loop again: "
                             f"{out['resume_last']}")
    return out


def phase_checkpoint(device, n: int) -> dict:
    """Checkpoint and resume on the card, on the mixture fitted as the
    validation rows are (``mixture_aspire``, nsf-tpu) at ``n``:

    (1)-(3) ``checkpoint_checks`` on the whole-chain route (B2 a rung, B3
    the initial draws) and (4) on the split route (``fused_chain=False``,
    CHAIN_STEPS + 2 B1 launches a rung);
    (5) the HDF5 paths (``checkpoint_path``, ``Aspire.resume_from_file``):
    where h5py is missing each raises ``ImportError`` naming it; where it is
    present a run file is written and resumed;
    (6) the pipeline with a checkpoint every rung (each state serialised to
    bytes, as a file writer would pickle it), with the states only built,
    and with none, in turns after a warm-up, medians of 3, and the bytes a
    checkpoint takes. PT and MCMC state checkpoints are files only, as in
    the JAX package: they run in the CPU tests.
    """
    import importlib.util
    import tempfile

    from aspire_tpu_torch import Aspire
    from aspire_tpu_torch.samplers.base import Sampler

    p, asp = mixture_aspire(device)
    truth = p.true_log_evidence()
    run = dict(sampler="smc", n_samples=n, store_sample_history=False,
               sampler_kwargs=dict(n_steps=CHAIN_STEPS))
    out = {"n": n, "fused": checkpoint_checks(asp, run, {"chain": 1}, truth)}
    b3 = checkpoint_run(asp, run, device_ladder=True)["launches"]["coupling"]
    out["fused"]["b3_launches"] = b3
    if device.type == "cuda" and b3 < 1:
        raise AssertionError("the initial draws did not launch B3")
    split_run = dict(run, sampler_kwargs=dict(n_steps=CHAIN_STEPS,
                                              fused_chain=False))
    out["split"] = checkpoint_checks(asp, split_run,
                                     {"coupling": CHAIN_STEPS + 2}, truth)

    has_h5py = importlib.util.find_spec("h5py") is not None
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/run.h5"
        try:
            asp.sample_posterior(**run, checkpoint_path=path)
            resumed = Aspire.resume_from_file(
                path, log_likelihood=p.log_likelihood,
                log_prior=p.log_prior, device=device)
            post = resumed.sample_posterior()
            check_result(post, n, truth, asp.dims)
            files = "h5py present: a run file written and resumed"
        except ImportError as err:
            if has_h5py or "'h5py'" not in str(err):
                raise
            try:
                Aspire.resume_from_file(path, log_likelihood=p.log_likelihood,
                                        log_prior=p.log_prior, device=device)
                raise AssertionError("resume_from_file ran without h5py")
            except ImportError as err2:
                if "'h5py'" not in str(err2):
                    raise
            files = ("h5py absent: checkpoint_path and resume_from_file "
                     "each raised ImportError naming h5py")
    out["files"] = files
    log(files)

    sizes = []

    def to_bytes(state):
        sizes.append(len(Sampler.serialize_checkpoint_state(state)))

    # "state": the states built and dropped; "on": built and serialised.
    # A warm-up of each, then in turns (off, state, on, on, state, off, off,
    # state, on).
    callbacks = {"off": None, "state": lambda state: None, "on": to_bytes}
    walls = {mode: [] for mode in callbacks}
    turns = ("off", "state", "on", "on", "state", "off", "off", "state", "on")
    for i, mode in enumerate(("off", "state", "on", *turns)):
        r = checkpoint_run(asp, run, device_ladder=True,
                           callback=callbacks[mode])
        if i >= 3:
            walls[mode].append(r["wall_s"])
    med = {mode: sorted(w)[1] for mode, w in walls.items()}
    n_states = out["fused"]["states"]
    out["times"] = {
        "off_s": med["off"], "on_s": med["on"], "state_s": med["state"],
        "walls_s": walls, "checkpoints_a_run": n_states,
        "ms_per_checkpoint": (med["on"] - med["off"]) / n_states * 1e3,
        "ms_per_state": (med["state"] - med["off"]) / n_states * 1e3,
        "bytes_per_checkpoint": [min(sizes), max(sizes)]}
    log(f"pipeline with a checkpoint every rung vs none: {out['times']}")
    return out


def checkpoint_alone() -> dict:
    """``phase_checkpoint`` alone at N_PIPELINE after the kernels' build
    and the mixture's fit, its lines printed; its times, the bytes a
    checkpoint takes, the file paths' case and the phase's seconds."""
    import torch

    from aspire_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    _build.load_library()
    device = torch.device("cuda")
    mixture_aspire(device)
    t0 = time.perf_counter()
    ck = phase_checkpoint(device, N_PIPELINE)
    phase_s = time.perf_counter() - t0
    report_checkpoint(card_line(), ck)
    return {"n": ck["n"], "times": ck["times"], "files": ck["files"],
            "phase_s": phase_s}


def report_checkpoint(card: str, ck: dict) -> None:
    """Print ``phase_checkpoint``'s results, one line each."""
    for route, v in (("whole-chain route (B2)", ck["fused"]),
                     ("split route (B1)", ck["split"])):
        r = v["resume"]
        print(f"[{card}] checkpoints, {route}, n={ck['n']}: every rung's "
              f"state ({v['states']} a run of {v['rungs']} rungs) changed "
              f"nothing (same bits: {v['same_bits']}; launches on "
              f"{v['launches_on']} vs off {v['launches_off']}; replays "
              f"{v['replays']}, one ladder {v['one_ladder']}; the host "
              f"ladder's states the same bits: "
              f"{v['host_ladder_states_same_bits']}); rung "
              f"{r['from_iteration']}'s {r['bytes']} bytes resumed on both "
              f"ladders, same bits {r['ladders_same_bits']}, {r['rungs']} "
              f"rungs, log Z {r['log_z']:.4f} +/- {r['log_z_err']:.4f} "
              f"(launches {r['launches']}, host ladder {r['host_launches']});"
              f" the last state resumed: {v['resume_last']['rungs']} rungs "
              f"kept, launches {v['resume_last']['launches']}", flush=True)
    t = ck["times"]
    print(f"[{card}] pipeline with a checkpoint every rung (serialised to "
          f"bytes) vs none, n={ck['n']}, in turns: {t['on_s']:.4f} s vs "
          f"{t['off_s']:.4f} s (medians of 3; {t['checkpoints_a_run']} "
          f"checkpoints a run, {t['ms_per_checkpoint']:.3f} ms each, "
          f"{t['ms_per_state']:.3f} ms of it building the state: "
          f"{t['state_s']:.4f} s a run without the bytes, "
          f"{t['bytes_per_checkpoint'][0]}-{t['bytes_per_checkpoint'][1]} "
          f"bytes each); file paths: {ck['files']}; PT and MCMC state "
          f"checkpoints are files only (CPU tests)", flush=True)


def report_ptmcmc(card: str, pt: dict) -> None:
    """Print ``phase_ptmcmc``'s results, one line each."""
    c = pt["device_check"]
    print(f"[{card}] PT on the card vs the CPU (float64, bounded Gaussian, "
          f"{c['n_temps']} rungs x {c['n']} walkers, {c['rounds']} rounds of "
          f"{c['swap_every']} moves, {c['draws']} draws replayed): max |diff| "
          f"{c['max_abs_diff']}", flush=True)
    for row, v in pt["rows"].items():
        r = v["runs"][0]
        print(f"[{card}] PT row {row}, {r['walkers']} walkers, "
              f"{PT_KWARGS}: stepping-stone log Z {v['log_z']:.4f} +/- "
              f"{v['log_z_err']:.4f} vs {v['truth']:.4f}"
              f"{' (3 fits combined)' if len(v['runs']) > 1 else ''}; "
              + "; ".join(
                  f"fit {i + 1}: TI {u['ti_log_z']:.4f} +/- {u['ti_err']:.4f}"
                  f", {u['rungs']} rungs, move acceptance "
                  f"{u['move_acceptance_mean']:.3f}, min swap acceptance "
                  f"{u['swap_acceptance_min']:.3f}, {u['wall_s']:.3f} s, "
                  f"{u['evaluations']} evaluations, {u['rounds']} rounds, "
                  f"{u['s_per_round'] * 1e3:.3f} ms a round"
                  + (f" ({u['round_profile']['ops']} device ops, "
                     f"{u['round_profile']['device_ms']:.3f} ms of device "
                     f"time)" if "round_profile" in u else "")
                  + f", B3 {u['b3']}" for i, u in enumerate(v["runs"])),
              flush=True)
    v = pt["flow"]
    print(f"[{card}] PT with preconditioning=\"flow\" (nsf-tpu inside) on "
          f"the bounded Gaussian, {v['n_temperatures']} rungs x "
          f"{v['n_samples']} walkers, {v['n_steps']} moves: stepping-stone "
          f"log Z {v['log_z']:.4f} +/- {v['log_z_err']:.4f} (truth "
          f"{v['truth']:.4f}, not gated), {v['wall_s']:.3f} s, B3 {v['b3']}",
          flush=True)
    v = pt["smc_replicates"]
    print(f"[{card}] SMC n_replicates=3 on the mixture, n={N_VALIDATE}: "
          f"log Z {v['log_z']:.4f} +/- {v['log_z_err']:.4f} (replicates "
          f"{[round(z, 4) for z in v['replicates']]}) vs {v['truth']:.4f}, "
          f"{v['wall_s']:.3f} s", flush=True)


def report_new_paths(card: str, cnf: dict, fp: dict, mcmc: dict) -> None:
    """Print ``phase_cnf``'s, ``phase_flow_preconditioning``'s and
    ``phase_mcmc``'s results, one line each."""
    c = cnf["device_check"]
    print(f"[{card}] CNF (d={c['dims']}, {c['n_hidden']}, {c['n_steps']} RK4 "
          f"steps), n={c['n']}: log_prob on the card vs the CPU max |diff| "
          f"{c['log_prob_max_abs_diff_cpu']:.3g} (vs float64: card "
          f"{c['log_prob_max_abs_err_f64']:.3g}, CPU "
          f"{c['log_prob_cpu_max_abs_err_f64']:.3g}), one pass "
          f"{c['log_prob_s']:.4f} s; sampling pass {c['inverse_s']:.4f} s",
          flush=True)
    for row, v in cnf["rows"].items():
        imp, smc = v["importance"], v["smc"]
        print(f"[{card}] CNF row {row} (d={v['dims']}), fit "
              f"{v['fit_s']:.2f} s: importance log Z {imp['log_z']:.4f} +/- "
              f"{imp['log_z_err']:.4f}, efficiency {imp['efficiency']:.4f}"
              f"{' (informational)' if imp.get('informational') else ''}, "
              f"{imp['wall_s']:.3f} s; SMC log Z {smc['log_z']:.4f} +/- "
              f"{smc['log_z_err']:.4f} in {smc['rungs']} rungs on the "
              f"{smc['ladder']} ladder, {smc['wall_s']:.3f} s (capture "
              f"{smc.get('capture_s') or 0.0:.3f} s); truth {smc['truth']:.4f}",
              flush=True)
    v = cnf["pass_times"]
    print(f"[{card}] CNF (mixture, fitted), n={v['n']}: one density pass "
          f"{v['log_prob_s']:.4f} s, one sampling pass {v['sample_s']:.4f} "
          f"s", flush=True)
    v = cnf["pipeline"]
    print(f"[{card}] CNF mixture pipeline, n={N_PIPELINE}, "
          f"{CNF_PIPELINE_STEPS}-step tpCN: device ladder "
          f"walls {[round(w, 4) for w in v['device_walls_s']]} s (the first "
          f"captures) vs host ladder {v['host_s']:.4f} s; {v['rungs']} rungs;"
          f" capture {v['capture_s'] or 0.0:.3f} s; one replay "
          f"{v.get('replay_device_ops')} kernels; one population: "
          f"{v['ladders_agree_bitwise']}; log Z {v['log_z']:.4f} +/- "
          f"{v['log_z_err']:.4f} vs host {v['host_log_z']:.4f}", flush=True)
    for inner in ("nsf-tpu", "cnf"):
        v = fp[inner]
        print(f"[{card}] SMC with preconditioning=\"flow\" ({inner} inside,"
              f" refitted by {v['fit_kwargs']}) on the 4-d mixture, "
              f"n={N_VALIDATE}: log Z {v['log_z']:.4f} +/- "
              f"{v['log_z_err']:.4f} vs {v['truth']:.4f}; {v['rungs']} rungs "
              f"on the {v['ladder']} ladder, {v['wall_s']:.3f} s; a rung "
              f"{v['b3_per_rung']:.1f} B3 and {v['b1_per_rung']:.1f} B1",
              flush=True)
    for name, v in mcmc.items():
        print(f"[{card}] {name} on the bounded Gaussian, {v['walkers']} "
              f"walkers, {v['n_steps']} steps, burn-in {v['burn_in']}: "
              f"acceptance {v['acceptance']:.3f}, tau "
              f"{[round(t, 2) for t in v['tau']]}, mean "
              f"{[round(m, 4) for m in v['mean']]}, sd "
              f"{[round(s, 4) for s in v['sd']]}, {v['wall_s']:.3f} s, "
              f"B3 {v['b3']}", flush=True)


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


def chain_bound(arch, n: int, steps: int, target_flop: int = 0) -> dict:
    """B2's bound for one ``steps``-step chain of n particles: one flow
    density per step and one for the start (the first conditioner layer
    on the FP32 pipe, the two wide ones on the tensor cores in split
    TF32), and ``target_flop`` FP32 operations of the target per density;
    z0 read, z and four per-particle outputs written, the packed weights
    read once."""
    from aspire_tpu_torch.ops import fused_mutation as FM

    first, wide = ((steps + 1) * n * f for f in coupling_flop_parts(arch))
    return bound(first + (steps + 1) * n * target_flop,
                 n * (2 * arch.dims + 4) * 4
                 + 4 * arch.n_layers * FM.chain_layout(arch)[0],
                 tensor_flop=wide)


def regression_flop(dims: int) -> int:
    """``REGRESSION_CUDA``'s FP32 operations per point: per data point
    Horner's 2 (d - 1), the residual, its scaling and its square summed
    (4); the prior's square sum (2 d)."""
    return REGRESSION_POINTS * (2 * (dims - 1) + 4) + 2 * dims


@fitted_once
def hierarchical_aspire(device):
    """BASELINE config 5's problem and flow (benchmarks/hierarchical.py): the
    d = 32 hierarchical posterior, nsf 6 x (128, 128), 8 bins, fitted on
    N_HIER_TRAIN draws of ``default_rng(7)`` (20 epochs, batch 1024); and
    the fit's seconds."""
    import numpy as np
    import torch

    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import HierarchicalProblem

    problem = HierarchicalProblem(32)
    initial = Samples(problem.draw_initial_samples(np.random.default_rng(7),
                                                   N_HIER_TRAIN))
    asp = Aspire(log_likelihood=problem.log_likelihood,
                 log_prior=problem.log_prior, dims=32, flow_backend="nsf",
                 n_layers=6, n_hidden=(128, 128), seed=3, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    asp.fit(initial, n_epochs=20, batch_size=1024)
    torch.cuda.synchronize()
    return problem, asp, time.perf_counter() - t0


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
    import torch

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
    reset_launch_counts()
    _, asp, fit_s = hierarchical_aspire(device)
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
    smc_evals = asp.sampler.n_likelihood_evaluations
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
    # Four turns: a run at this n takes ~7 s (the script's time).
    ladders = ladder_turns(asp, smc_run, {"chain": 1}, warm=False,
                           turns=("device", "host", "host", "device"))
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
        "smc_capture_s": capture_s, "smc_evaluations": smc_evals,
        "ladders": ladders,
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


def check_result(samples, n: int, truth: float, dims: int = 4) -> None:
    import torch

    if tuple(samples.x.shape) != (n, dims) or not bool(
            torch.isfinite(samples.x).all()):
        raise AssertionError(f"posterior samples are not finite (n, {dims})")
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

    seconds = {"build": time.perf_counter() - t0}

    def timed(fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__] = time.perf_counter() - t
        return out

    main_path = timed(phase_main_path, device, N_CHAIN, N_PIPELINE)
    main_path["uncapturable_target"] = timed(phase_uncapturable_target,
                                             device, N_CHAIN)
    bounded = timed(phase_bounded_path, device, N_CHAIN, N_PIPELINE)
    validate = timed(phase_validate_targets, device, N_VALIDATE, N_PIPELINE)
    replicated = timed(phase_replicated, device, N_VALIDATE, N_CHAIN)
    validate["funnel"]["anchor"] = replicated["funnel"]["anchor"]
    user = timed(phase_user_target, device, N_CHAIN, N_PIPELINE)
    gradient = timed(phase_gradient_samplers, device, N_VALIDATE,
                     N_PIPELINE)
    maf_path = timed(phase_maf_main_path, device, N_CHAIN, N_PIPELINE)
    hier = timed(phase_hierarchical, device)
    opts = timed(phase_smc_options, device, N_VALIDATE, N_PIPELINE)
    mesh = timed(phase_mesh, device, N_PIPELINE)
    coupling = timed(phase_coupling, device, N_COUPLING)
    chain = timed(phase_chain, device, N_CHAIN, CHAIN_STEPS)
    maf = timed(phase_maf, device, N_COUPLING)
    chain_t = timed(time_chain, device, N_PIPELINE, CHAIN_STEPS)
    staged = timed(phase_staged_coupling, device, N_COUPLING)
    uniforms = timed(phase_prng, device, N_PIPELINE)
    cnf = timed(phase_cnf, device, N_VALIDATE, N_PIPELINE)
    flow_precond = timed(phase_flow_preconditioning, device, N_VALIDATE)
    mcmc = timed(phase_mcmc, device, N_VALIDATE)
    pt = timed(phase_ptmcmc, device, N_VALIDATE)
    ck = timed(phase_checkpoint, device, N_PIPELINE)
    # The profiler last: after it has traced the card, every launch costs
    # the host more, and the pipelines and short kernels' events show it.
    timed(read_kernel_ms)
    log(f"seconds per phase: {seconds}; in all "
        f"{time.perf_counter() - t0:.1f} s")

    bl, bp, bt = bounded["logit"], bounded["periodic"], bounded["times"]
    print(f"[{card}] bounded Gaussian (d=4, U(-10, 10), logit + affine data "
          f"transform), n={N_PIPELINE}: device ladder "
          f"{bl['ladders']['device_s']:.4f} s vs host ladder "
          f"{bl['ladders']['host_s']:.4f} s (medians of 3 in turns; "
          f"{bl['ladders']['rungs']} rungs, per rung {bl['per_rung']}); "
          f"split route: device ladder {bl['ladders_split']['device_s']:.4f} "
          f"s vs host ladder {bl['ladders_split']['host_s']:.4f} s; anchor "
          f"log Z {bl['anchor']['log_z']:.4f} +/- "
          f"{bl['anchor']['log_z_err']:.4f} vs {bl['anchor']['truth']:.4f}; "
          f"periodic (host ladder, pc program): B2 {bp['routes']['fused_s']:.4f}"
          f" s vs split {bp['routes']['split_s']:.4f} s, anchor log Z "
          f"{bp['anchor']['log_z']:.4f} +/- {bp['anchor']['log_z_err']:.4f}; "
          f"probit anchor {bounded['probit']['anchor']['log_z']:.4f} +/- "
          f"{bounded['probit']['anchor']['log_z_err']:.4f}", flush=True)
    print(f"[{card}] chain kernel with transform programs, n={N_PIPELINE}, "
          f"{CHAIN_STEPS} steps, in turns with affine-only: " + "; ".join(
              f"{k} {v['ms']} ms events, {v['kernel_ms']:.4f} ms alone"
              for k, v in bt.items()) + f"; plain torch (logit) "
          f"{bt['logit']['plain_ms']:.4f} ms; shared memory at d=32 "
          f"{bounded['shared_bytes_d32']} B", flush=True)
    for row, v in ((r, validate[r]) for r in VALIDATE_ROWS):
        k, a, lb, ls = (v["kernels"], v["anchor"], v["ladders"],
                        v["ladders_split"])
        print(f"[{card}] validation row {row} (d={k['d']}, nsf-tpu, "
              f"configuration {a['runs'][0]['config']}): anchor n="
              f"{N_VALIDATE} log Z {a['log_z']:.4f} +/- {a['log_z_err']:.4f}"
              f" vs quadrature {a['truth']:.4f} ({len(a['runs'])} fit(s)); "
              f"pipeline n={N_PIPELINE}: device ladder {lb['device_s']:.4f} "
              f"s vs host ladder {lb['host_s']:.4f} s on B2 ({lb['rungs']} "
              f"rungs, per rung {v['per_rung']}); split route "
              f"{ls['device_s']:.4f} s vs {ls['host_s']:.4f} s, log Z "
              f"{ls['log_z']:.4f} vs B2 {lb['log_z']:.4f}; B1 "
              f"{k['ms']:.4f} ms events, {k['kernel_ms']:.4f} ms alone "
              f"(plain {k['plain_ms']:.4f}), B3 {k['inverse_ms']:.4f} / "
              f"{k['inverse_kernel_ms']:.4f} ms (plain "
              f"{k['inverse_plain_ms']:.4f}); B2 {k['chain_ms']:.4f} ms "
              f"events, {k['chain_kernel_ms']:.4f} ms alone (plain "
              f"{k['chain_plain_ms']:.4f})", flush=True)
    report_replicated(card, replicated, seconds["phase_replicated"])
    ul, us, ut, ub = (user["ladders"], user["ladders_split"], user["times"],
                      user["build"])
    print(f"[{card}] user target (polynomial regression, d=4, "
          f"{REGRESSION_POINTS} points; its CUDA source in a B2 instance of "
          f"its own): build {ub['cold_s']:.1f} s cold, {ub['cached_s']:.3f} "
          f"s cached; anchor n={N_CHAIN} log Z {user['anchor']['log_z']:.4f}"
          f" +/- {user['anchor']['log_z_err']:.4f} vs analytic "
          f"{user['truth']:.4f}; pipeline n={N_PIPELINE}: device ladder "
          f"{ul['device_s']:.4f} s vs host ladder {ul['host_s']:.4f} s on B2 "
          f"({ul['rungs']} rungs, per rung {user['per_rung']}); split route "
          f"{us['device_s']:.4f} s vs {us['host_s']:.4f} s, log Z "
          f"{us['log_z']:.4f} vs B2 {ul['log_z']:.4f}; B2 on it "
          f"{ut['user']['ms']} ms events, {ut['user']['kernel_ms']:.4f} ms "
          f"alone, in turns with B2 on the mixture {ut['mixture']['ms']} ms "
          f"events, {ut['mixture']['kernel_ms']:.4f} ms alone (plain "
          f"{ut['user']['plain_ms']:.4f}); evaluation entry "
          f"{user['eval']['ms']:.4f} ms vs callables "
          f"{user['eval']['plain_ms']:.4f} ms at n={N_PIPELINE}", flush=True)
    report_gradient(card, gradient)
    report_smc_options(card, opts, hier)
    report_mesh(card, mesh, seconds["phase_mesh"])
    report_new_paths(card, cnf, flow_precond, mcmc)
    report_ptmcmc(card, pt)
    report_checkpoint(card, ck)
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
                    ("bounded nsf-tpu", bl["replay_vs_eager"]),
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
         "launches_gradient_pipelines": {
             name: v["launches"]["coupling"]
             for name, v in gradient["pipelines"].items()},
         "launches_per_rung_gradient_pipelines": {
             name: v["per_rung"]
             for name, v in gradient["pipelines"].items()},
         "launches_gradient_anchors": {
             name: v["launches"]["coupling"]
             for name, v in gradient["anchors"].items()},
         "gradient_checks": {k: v for k, v in gradient["gradients"].items()
                             if k.startswith("nsf")},
         "launches_flow_preconditioning": {
             inner: {k: flow_precond[inner][k] for k in (
                 "b1", "b3", "rungs", "b1_per_rung", "b3_per_rung")}
             for inner in ("nsf-tpu", "cnf")},
         "launches_b3_mcmc": {name: v["b3"] for name, v in mcmc.items()},
         "launches_b3_pt_rows": {row: [r["b3"] for r in v["runs"]]
                                 for row, v in pt["rows"].items()},
         "launches_b3_pt_flow_preconditioned": pt["flow"]["b3"],
         "launches_smc_options": {
             "rows": {k: v["launches"]["coupling"]
                      for k, v in opts["rows"].items()},
             "rows_b3": {k: v["launches"]["b3"]
                         for k, v in opts["rows"].items()},
             "pipelines_last_device_run": {
                 k: v["launches"]["coupling"]
                 for k, v in opts["pipelines"].items()},
             "pipelines_b3_per_run": {
                 k: [r["b3"] for r in v["per_run"]]
                 for k, v in opts["pipelines"].items()},
             "per_rung": {k: v["per_rung"]
                          for k, v in opts["pipelines"].items()}},
         "launches_mesh": {
             world: {**{impl: {k: r["runs"][impl][k]
                               for k in ("b1", "b3", "rungs")}
                        for impl in MESH_IMPLS},
                     **{f"device_ladder_{impl}": {
                         k: r["ladder"][impl][k]
                         for k in ("b1", "b3", "b2", "rungs", "replays",
                                   "mode")}
                        for impl in MESH_IMPLS}}
             for world, r in (
                 *((f"nccl_world_{len(mesh['nccl'])}_rank_{k}", q)
                   for k, q in enumerate(mesh["nccl"])),
                 *((f"gloo_world_2_rank_{k}", q)
                   for k, q in enumerate(mesh["gloo"])))},
         "launches_checkpoint_phase": {
             "b3_initial_draws": ck["fused"]["b3_launches"],
             "b1_split_checkpointed_run": ck["split"]["launches_on"][
                 "coupling"],
             "b1_split_resumed_device_ladder": ck["split"]["resume"][
                 "launches"]["coupling"]},
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
         "launches_checkpoint_phase": {
             "checkpointed_run": ck["fused"]["launches_on"]["chain"],
             "resumed_device_ladder": ck["fused"]["resume"]["launches"][
                 "chain"],
             "resumed_host_ladder": ck["fused"]["resume"]["host_launches"][
                 "chain"]},
         "launches_per_replay_profiled": main_path["replay_vs_eager"][
             "replay_kernels"]["chain"],
         "max_abs_err": chain["max_abs_err"],
         "ms": chain_t["ms"], "ms_single_call": chain_t["ms_single_call"],
         "kernel_ms": chain_t["kernel_ms"],
         "plain_ms": chain_t["plain_ms"], **b2_bound, "library_ms": None},
        {"name": "chain_kernel B2, transform programs", "route": "cuda",
         "config": "bounded GaussianProblem(dims=4), nsf-tpu; logit + affine "
                   "data transform (times: chain_setup's flow and target)",
         "source": "aspire_tpu_torch/csrc/chain.cu",
         "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
         "launches": bl["ladders"]["launches"]["chain"],
         "launches_run": "bounded pipeline, device ladder",
         "device_ladder_rungs": bl["ladders"]["rungs"],
         "launches_per_rung": bl["per_rung"],
         "launches_per_replay_profiled": bl["replay_vs_eager"][
             "replay_kernels"]["chain"],
         "max_abs_err": max(bounded["check_max_abs_err"].values()),
         "max_abs_err_by_program": bounded["check_max_abs_err"],
         "ms": sum(bt["logit"]["ms"]) / 2, "kernel_ms": bt["logit"][
             "kernel_ms"], "plain_ms": bt["logit"]["plain_ms"],
         **b2_bound, "library_ms": None,
         "by_program": bt, "shared_bytes_d32": bounded["shared_bytes_d32"]},
        {"name": "maf_kernel (B4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/maf.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:598",
         "launches": maf_path["launches"]["maf"],
         "launches_device_ladder": maf_path["ladders"]["launches"]["maf"],
         "launches_per_replay_profiled": maf_path["replay_vs_eager"][
             "replay_kernels"]["maf"],
         "launches_gradient_pipeline": gradient["maf_rqs_mala"]["launches"][
             "maf"],
         "launches_per_rung_gradient_pipeline": gradient["maf_rqs_mala"][
             "per_rung"],
         "gradient_check": gradient["gradients"]["maf-rqs d=4"],
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
         "launches_waste_free": opts["config5"][-1]["launches"]["coupling"],
         "launches_per_rung_waste_free": opts["config5"][-1]["per_rung"][
             "coupling"],
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
    for row, v in ((r, validate[r]) for r in VALIDATE_ROWS):
        k, d = v["kernels"], v["kernels"]["d"]
        arch = nsf_tpu(d)
        where = (f"{row} validation row: nsf-tpu at d={d}, configuration "
                 f"{v['anchor']['runs'][0]['config']}")
        kernels.append({
            "name": f"coupling_kernel B1/B3, d={d}", "route": "cuda",
            "config": where, "source": "aspire_tpu_torch/csrc/coupling.cu",
            "replaces": "aspire_tpu/ops/fused_coupling.py:445",
            "launches": v["ladders_split"]["launches"]["coupling"],
            "launches_run": "split route pipeline, device ladder",
            "launches_anchor_draws": sum(
                a["launches"]["coupling"] for a in v["anchor"]["runs"]),
            "max_abs_err": k["max_abs_err"],
            **{key: k[key] for key in (
                "ms", "ms_single_call", "kernel_ms", "plain_ms",
                "inverse_ms", "inverse_ms_single_call", "inverse_kernel_ms",
                "inverse_plain_ms")},
            **coupling_bound(arch, N_COUPLING), "library_ms": None})
        kernels.append({
            "name": f"chain_kernel B2, d={d}", "route": "cuda",
            "config": where + f", {row} target, program level "
                              f"{k['chain_program_level']}",
            "source": "aspire_tpu_torch/csrc/chain.cu",
            "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
            "launches": v["ladders"]["launches"]["chain"],
            "launches_run": "pipeline, device ladder",
            "launches_anchor": sum(a["launches"]["chain"]
                                   for a in v["anchor"]["runs"]),
            "max_abs_err": k["chain_max_abs_err"],
            "ms": k["chain_ms"], "ms_single_call": k["chain_ms_single_call"],
            "kernel_ms": k["chain_kernel_ms"], "plain_ms": k["chain_plain_ms"],
            **chain_bound(arch, N_PIPELINE, CHAIN_STEPS), "library_ms": None})
    kernels.append({
        "name": "chain_kernel B2, user target", "route": "cuda",
        "config": f"a user's polynomial regression (d=4, {REGRESSION_POINTS}"
                  " points) as CUDA source, its own instance of B2 at "
                  "configuration 0 (nsf-tpu)",
        "source": "aspire_tpu_torch/csrc/chain.cu",
        "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
        "launches": ul["launches"]["chain"],
        "launches_run": "user target pipeline, device ladder",
        "launches_anchor": user["anchor"]["launches"]["chain"],
        "max_abs_err": max(user["chain_max_abs_err"],
                           user["wide_chain_max_abs_err"]),
        "wide_max_abs_err": user["wide_chain_max_abs_err"],
        "ms": sum(ut["user"]["ms"]) / 2,
        "ms_single_call": ut["user"]["ms_single_call"],
        "kernel_ms": ut["user"]["kernel_ms"],
        "plain_ms": ut["user"]["plain_ms"],
        "mixture_ms": ut["mixture"]["ms"],
        "mixture_kernel_ms": ut["mixture"]["kernel_ms"],
        **chain_bound(nsf4, N_PIPELINE, CHAIN_STEPS, regression_flop(4)),
        "library_ms": None, "build_s": ub["cold_s"],
        "build_cached_s": ub["cached_s"], "ptxas": ub["ptxas"],
        "eval_ms": user["eval"]["ms"],
        "eval_plain_ms": user["eval"]["plain_ms"]})
    kernels.append(rwmh_kernel_row(gradient, b2_bound))
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
    if len(sys.argv) == 2 and sys.argv[1] == "--smc-options":
        print(card_line(), flush=True)
        print(json.dumps({"smc_options": smc_options_alone()}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--checkpoint":
        print(card_line(), flush=True)
        print(json.dumps({"checkpoint": checkpoint_alone()}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--replicated":
        print(card_line(), flush=True)
        print(json.dumps({"replicated": replicated_alone()}), flush=True)
        sys.exit(0)
    if len(sys.argv) == 2 and sys.argv[1] == "--mesh":
        print(card_line(), flush=True)
        print(json.dumps({"mesh": mesh_alone()}), flush=True)
        sys.exit(0)
    sys.exit(main())
