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
8. print kernel and plain times (median of per-call CUDA-event times), the
   kernels JSON line and the result line.
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

    for counter in (FC.launches, FC.maf_launches, FM.launches):
        counter.reset()


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
    kernels = [
        {"name": "coupling_kernel (B1 density / B3 sampling)",
         "route": "cuda", "source": "aspire_tpu_torch/csrc/coupling.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:445",
         "launches": main_path["launches"]["coupling"],
         "max_abs_err": coupling["max_abs_err"],
         "ms": coupling["ms"], "plain_ms": coupling["plain_ms"],
         "inverse_ms": coupling["inverse_ms"],
         "inverse_plain_ms": coupling["inverse_plain_ms"]},
        {"name": "chain_kernel (B2)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/chain.cu",
         "replaces": "aspire_tpu/ops/fused_mutation.py:1038",
         "launches": main_path["launches"]["chain"],
         "max_abs_err": chain["max_abs_err"],
         "ms": chain_t["ms"], "plain_ms": chain_t["plain_ms"]},
        {"name": "maf_kernel (B4)", "route": "cuda",
         "source": "aspire_tpu_torch/csrc/maf.cu",
         "replaces": "aspire_tpu/ops/fused_coupling.py:598",
         "launches": maf_path["launches"]["maf"],
         "max_abs_err": maf["max_abs_err"],
         "ms": maf["ms"], "plain_ms": maf["plain_ms"],
         "wrapper_ms": maf["wrapper_ms"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
