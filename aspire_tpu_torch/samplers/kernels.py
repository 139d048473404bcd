"""MCMC mutation kernels over particle batches: the per-step ("split") chain.

Counterpart of ``aspire_tpu/samplers/kernels.py``: pCN / tpCN / RWMH,
MALA, HMC (with a jittered trajectory length), NUTS and the stretch move.
Every kernel advances the whole ``(n, d)`` particle array per step;
randomness comes from an explicit ``torch.Generator`` through
:func:`_normal`, :func:`_uniform` and :func:`_randint`, in the JAX
package's order of draws within a step. The target density of each step
goes through the flow's ``forward``, so on a CUDA tensor the coupling or
MAF kernel evaluates it (a gradient kernel's backward recomputes through
the plain path, as the JAX package's ``custom_vjp`` does). The whole-chain
kernel (:mod:`aspire_tpu_torch.ops.fused_mutation`) replaces this loop
where its predicate holds.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


@dataclass
class ChainState:
    x: torch.Tensor  # (n, d) positions
    log_prob: torch.Tensor  # (n,)
    step_size: torch.Tensor  # 0-d, adapted
    n_accept: torch.Tensor  # (n,)
    #: (n, d) cached gradients of ``log_prob`` (MALA, HMC, NUTS), else None
    grad: torch.Tensor | None = None
    #: 0-d int64 count of target evaluations, on the device: NUTS and the
    #: jittered HMC add a count that depends on the data, which is never
    #: read back during the chain (zero when not given)
    n_evals: torch.Tensor | None = None

    def __post_init__(self):
        if self.n_evals is None:
            self.n_evals = torch.zeros((), dtype=torch.int64,
                                       device=self.x.device)


class GaussianReference(NamedTuple):
    mean: torch.Tensor  # (d,)
    chol: torch.Tensor  # (d, d) lower Cholesky factor of the covariance
    inv_chol: torch.Tensor  # (d, d)


class ChainStats(NamedTuple):
    tau: torch.Tensor
    mixing: torch.Tensor


def gaussian_reference_info(x: torch.Tensor, jitter: float = 1e-6
                            ) -> tuple[GaussianReference, torch.Tensor]:
    """Ensemble mean and covariance of the particles, and ``cholesky_ex``'s
    ``info`` (0 where the covariance factorised), with no host sync: the
    device ladder carries ``info`` into its fault flags."""
    mean = torch.mean(x, dim=0)
    xc = x - mean
    eye = torch.eye(x.shape[1], dtype=x.dtype, device=x.device)
    cov = (xc.T @ xc) / x.shape[0] + jitter * eye
    chol, info = torch.linalg.cholesky_ex(cov)
    inv_chol = torch.linalg.solve_triangular(chol, eye, upper=False)
    return GaussianReference(mean=mean, chol=chol, inv_chol=inv_chol), info


def check_factorised(info, where: str = "") -> None:
    """Raise where ``cholesky_ex`` found the covariance not positive
    definite (``info``, a tensor or a number: a host read)."""
    if int(info):
        raise torch.linalg.LinAlgError(
            f"{where}the particles' covariance is not positive-definite (the "
            f"leading minor of order {int(info)} is not)")


def fit_gaussian_reference(x: torch.Tensor,
                           jitter: float = 1e-6) -> GaussianReference:
    """Ensemble mean and covariance of the particles; raises where the
    covariance does not factorise."""
    ref, info = gaussian_reference_info(x, jitter)
    check_factorised(info)
    return ref


def mahalanobis_sq(ref: GaussianReference, x: torch.Tensor) -> torch.Tensor:
    z = (x - ref.mean) @ ref.inv_chol.T
    return torch.sum(z**2, dim=-1)


def monotone_beta_bisect(ok: Callable, beta_prev, tol: float, dtype,
                         device) -> torch.Tensor:
    """Largest ``beta`` in ``[beta_prev, 1]`` whose predicate holds.

    Jumps to 1 when ``ok(1)`` holds, otherwise a fixed 54-halving
    bisection (no data-dependent trip count, so nothing syncs the host).
    """
    one = torch.ones((), dtype=dtype, device=device)
    prev = torch.as_tensor(beta_prev, dtype=dtype, device=device)
    lo = torch.where(ok(one), one, prev)
    hi = one
    for _ in range(54):
        done = hi - lo <= tol
        mid = 0.5 * (lo + hi)
        good = ok(mid)
        new_lo = torch.where(good, mid, lo)
        new_hi = torch.where(good, hi, mid)
        lo = torch.where(done, lo, new_lo)
        hi = torch.where(done, hi, new_hi)
    return lo


def _gamma_rejection(generator, alpha: float, n: int, dtype, device):
    """Marsaglia-Tsang Gamma(alpha, 1) for a non-half-integer shape."""
    a = alpha if alpha >= 1 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    out = torch.empty(n, dtype=dtype, device=device)
    todo = torch.ones(n, dtype=torch.bool, device=device)
    while bool(todo.any()):
        idx = torch.nonzero(todo)[:, 0]
        m = idx.numel()
        x = torch.randn(m, generator=generator, dtype=dtype, device=device)
        u = torch.rand(m, generator=generator, dtype=dtype, device=device)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        out[idx[ok]] = d * v[ok]
        todo[idx[ok]] = False
    if alpha < 1:
        u = torch.rand(n, generator=generator, dtype=dtype, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def gamma_fixed_shape(generator, alpha: float, n: int, dtype, device):
    """Gamma(alpha, 1); for integer ``2 alpha`` the closed construction
    ``sum of floor(alpha) exponentials (+ half a squared normal)``."""
    k = int(round(2.0 * alpha))
    if abs(2.0 * alpha - k) > 1e-9 or k <= 0:
        return _gamma_rejection(generator, alpha, n, dtype, device)
    m, odd = divmod(k, 2)
    out = torch.zeros(n, dtype=dtype, device=device)
    if m > 0:
        u = torch.rand((n, m), generator=generator, dtype=dtype,
                       device=device)
        out = -torch.sum(torch.log1p(-u), dim=-1)
    if odd:
        g = torch.randn(n, generator=generator, dtype=dtype, device=device)
        out = out + 0.5 * g**2
    return out


def adapt_step_size(step_size, accept_prob_mean, target_acceptance,
                    adaptation_rate, max_log_step: float = 0.0):
    """Robbins-Monro adaptation in log space, clipped to [-10, max]."""
    log_s = torch.log(step_size) + adaptation_rate * (
        accept_prob_mean - target_acceptance)
    return torch.exp(torch.clamp(log_s, -10.0, max_log_step)).to(
        step_size.dtype)


def _normal(generator, like):
    """Standard normals of ``like``'s shape, dtype and device."""
    return torch.randn(like.shape, generator=generator, dtype=like.dtype,
                       device=like.device)


def _uniform(generator, shape, like):
    """Uniforms on [0, 1) of ``shape`` (a length or a tuple) in ``like``'s
    dtype, on its device."""
    return torch.rand(shape, generator=generator, dtype=like.dtype,
                      device=like.device)


def _randint(generator, low: int, high: int, shape, like):
    """Integers in ``[low, high)`` of ``shape``, on ``like``'s device."""
    return torch.randint(low, high, shape, generator=generator,
                         device=like.device)


def mh_update(state: ChainState, generator, x_prop, lp_prop, log_alpha, *,
              target_acceptance: float, adaptation_rate: float,
              max_log_step: float = 0.0, grad_prop=None,
              eval_amount=None) -> ChainState:
    """NaN guard, accept/select and step adaptation, shared by kernels
    (the JAX package's ``_mh_update``): a NaN ``log_alpha`` (a NaN density
    or gradient) is a rejection. ``grad_prop`` is selected with the
    positions; ``eval_amount`` (a number or a 0-d tensor) is the step's
    target evaluations, n by default."""
    n = state.x.shape[0]
    log_alpha = torch.where(torch.isnan(log_alpha),
                            torch.full_like(log_alpha, -math.inf), log_alpha)
    u = _uniform(generator, n, state.x)
    accept = torch.log(u) < log_alpha
    acc_prob = torch.mean(torch.exp(torch.clamp(log_alpha, max=0.0)))
    grad = state.grad
    if grad_prop is not None:
        grad = torch.where(accept[:, None], grad_prop, state.grad)
    return ChainState(
        x=torch.where(accept[:, None], x_prop, state.x),
        log_prob=torch.where(accept, lp_prop, state.log_prob),
        step_size=adapt_step_size(state.step_size, acc_prob,
                                  target_acceptance, adaptation_rate,
                                  max_log_step=max_log_step),
        n_accept=state.n_accept + accept.to(state.x.dtype),
        grad=grad,
        n_evals=state.n_evals + (n if eval_amount is None else eval_amount),
    )


def pcn_step(state: ChainState, generator, log_prob_fn: Callable,
             ref: GaussianReference, target_acceptance: float = 0.234,
             adaptation_rate: float = 0.1) -> ChainState:
    """pCN under N(mean, chol chol^T)."""
    s = torch.clamp(state.step_size, max=1.0)
    xi = _normal(generator, state.x)
    x_prop = (ref.mean
              + torch.sqrt(torch.clamp(1 - s**2, min=0.0))
              * (state.x - ref.mean) + s * xi @ ref.chol.T)
    lp_prop = log_prob_fn(x_prop)
    log_alpha = lp_prop - state.log_prob + 0.5 * (
        mahalanobis_sq(ref, x_prop) - mahalanobis_sq(ref, state.x))
    return mh_update(state, generator, x_prop, lp_prop, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate)


def tpcn_step(state: ChainState, generator, log_prob_fn: Callable,
              ref: GaussianReference, nu: float = 5.0,
              target_acceptance: float = 0.234,
              adaptation_rate: float = 0.1) -> ChainState:
    """t-preconditioned Crank-Nicolson (scale mixture of pCN steps)."""
    n, d = state.x.shape
    s = torch.clamp(state.step_size, max=1.0)
    r2_old = mahalanobis_sq(ref, state.x)
    alpha_gamma = 0.5 * (nu + d)
    w = gamma_fixed_shape(generator, alpha_gamma, n, state.x.dtype,
                          state.x.device)
    w = w / (0.5 * (nu + r2_old))
    xi = _normal(generator, state.x)
    x_prop = (ref.mean
              + torch.sqrt(torch.clamp(1 - s**2, min=0.0))
              * (state.x - ref.mean)
              + (s / torch.sqrt(w))[:, None] * (xi @ ref.chol.T))
    lp_prop = log_prob_fn(x_prop)
    r2_new = mahalanobis_sq(ref, x_prop)
    log_alpha = lp_prop - state.log_prob + alpha_gamma * (
        torch.log(nu + r2_new) - torch.log(nu + r2_old))
    return mh_update(state, generator, x_prop, lp_prop, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate)


def rwmh_step(state: ChainState, generator, log_prob_fn: Callable,
              ref: GaussianReference, target_acceptance: float = 0.234,
              adaptation_rate: float = 0.1) -> ChainState:
    """Gaussian random walk with the ensemble-covariance proposal."""
    xi = _normal(generator, state.x)
    x_prop = state.x + state.step_size * xi @ ref.chol.T
    lp_prop = log_prob_fn(x_prop)
    return mh_update(state, generator, x_prop, lp_prop,
                     lp_prop - state.log_prob,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate, max_log_step=2.3)


def mala_step(state: ChainState, generator, value_and_grad_fn: Callable,
              target_acceptance: float = 0.574,
              adaptation_rate: float = 0.1) -> ChainState:
    """Metropolis-adjusted Langevin; the gradients ride in the state.
    ``value_and_grad_fn(x)`` returns ``(log_prob, grad)``."""
    eps = state.step_size
    xi = _normal(generator, state.x)
    mean_fwd = state.x + 0.5 * eps**2 * state.grad
    x_prop = mean_fwd + eps * xi
    lp_prop, grad_prop = value_and_grad_fn(x_prop)
    mean_rev = x_prop + 0.5 * eps**2 * grad_prop
    log_q_fwd = -torch.sum((x_prop - mean_fwd) ** 2, dim=-1) / (2 * eps**2)
    log_q_rev = -torch.sum((state.x - mean_rev) ** 2, dim=-1) / (2 * eps**2)
    log_alpha = lp_prop - state.log_prob + log_q_rev - log_q_fwd
    return mh_update(state, generator, x_prop, lp_prop, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate, max_log_step=2.3,
                     grad_prop=grad_prop)


def hmc_step(state: ChainState, generator, value_and_grad_fn: Callable,
             n_leapfrog: int = 10, target_acceptance: float = 0.651,
             adaptation_rate: float = 0.05,
             jitter_trajectory: bool = False) -> ChainState:
    """Hamiltonian step of ``n_leapfrog`` leapfrog integrations; the last
    one's evaluation is the proposal's (``n_leapfrog`` evaluations a step,
    not ``n_leapfrog + 1``).

    ``jitter_trajectory=True`` draws the length L uniformly in [1,
    n_leapfrog] per step (shared by the particles), as the JAX package
    does. The length stays on the device: all ``n_leapfrog`` integrations
    run and the state after the L-th is kept (the JAX package's L-step
    trajectory, bit for bit), so a CUDA graph captures the step and the
    host never reads L; the evaluation count is L n, the JAX package's.
    """
    n = state.x.shape[0]
    eps = state.step_size
    p0 = _normal(generator, state.x)
    length = (_randint(generator, 1, n_leapfrog + 1, (), state.x)
              if jitter_trajectory else None)
    x, p, grad, lp = state.x, p0, state.grad, state.log_prob
    for i in range(n_leapfrog):
        p_half = p + 0.5 * eps * grad
        x_new = x + eps * p_half
        lp_new, grad_new = value_and_grad_fn(x_new)
        p_new = p_half + 0.5 * eps * grad_new
        if length is None:
            x, p, grad, lp = x_new, p_new, grad_new, lp_new
        else:
            keep = length > i
            x, p, grad, lp = (torch.where(keep, new, old) for new, old in (
                (x_new, x), (p_new, p), (grad_new, grad), (lp_new, lp)))
    ke0 = 0.5 * torch.sum(p0**2, dim=-1)
    ke1 = 0.5 * torch.sum(p**2, dim=-1)
    log_alpha = (lp - ke1) - (state.log_prob - ke0)
    return mh_update(state, generator, x, lp, log_alpha,
                     target_acceptance=target_acceptance,
                     adaptation_rate=adaptation_rate, max_log_step=2.3,
                     grad_prop=grad,
                     eval_amount=(n_leapfrog * n if length is None
                                  else length * n))


# NUTS (iterative, bounded depth): the JAX package's per-particle tree
# doubling under ``vmap``, written out over the batch. Every particle that
# is still running is at the same doubling and the same leaf of it, so the
# leaf index, its trailing one-bits and the checkpoint stack's pointer are
# numbers shared by all; a particle that has stopped (a U-turn, a
# divergence) is masked, as the vmapped ``while_loop`` masks its lane.
# Scanning a subtree's leaves left to right, an even leaf is pushed; an
# odd leaf ``i`` with ``t`` trailing one-bits closes ``t`` nested subtrees,
# U-turn-checks against the top ``t`` stack entries and pops ``t - 1``.


def _trailing_ones(i: int, n_bits: int) -> int:
    """Number of contiguous low-order 1-bits of ``i`` (at most n_bits)."""
    count = 0
    while count < n_bits and (i >> count) & 1:
        count += 1
    return count


def _is_uturn(z_a, p_a, z_b, p_b) -> torch.Tensor:
    """Per row: the momenta at both ends point back across a -> b."""
    dz = z_b - z_a
    return (torch.sum(dz * p_a, dim=-1) < 0) | (torch.sum(dz * p_b, dim=-1)
                                                 < 0)


def _where(mask, new, old):
    """``new`` where the (n,) ``mask`` holds, ``old`` elsewhere, for (n,)
    and (n, d) tensors."""
    return torch.where(mask if new.dim() == 1 else mask[:, None], new, old)


def nuts_trajectory(generator, z0, lp0, grad0, value_and_grad_fn: Callable,
                    step_size, max_depth: int = 8,
                    max_delta_energy: float = 1000.0):
    """One NUTS trajectory for every particle: multinomial progressive
    sampling, the checkpoint stack's U-turn checks, ``max_depth`` doublings
    at most. Returns ``(z, lp, grad, accept_stat, n_leaf)``: ``accept_stat``
    is the mean Metropolis ratio over the visited leaves, ``n_leaf`` the
    leapfrogs each particle took (its evaluations).

    Draws per step, in order: the momenta; per doubling the directions
    (``u < 1/2`` is forward), the pick uniforms of all its leaves (one
    ``(2^depth, n)`` draw), one swap uniform. The host reads whether any
    particle still runs before each doubling and each leaf after the
    first, as the JAX package's batched ``while_loop``s test their lanes:
    the loops stop when every particle has, and a stopped particle's
    leaves in between are computed and discarded. A read costs far less
    than the leaf's gradient evaluation; a CUDA graph could not make it.
    """
    n, d = z0.shape
    p0 = _normal(generator, z0)
    h0 = 0.5 * torch.sum(p0 * p0, dim=-1) - lp0
    eps = step_size.to(z0.dtype)

    def leapfrog(z, p, grad):
        p_half = p + 0.5 * eps * grad
        z_new = z + eps * p_half
        lp_new, grad_new = value_and_grad_fn(z_new)
        return z_new, p_half + 0.5 * eps * grad_new, grad_new, lp_new

    zl, pl, gl = z0, p0, grad0
    zr, pr, gr = z0, p0, grad0
    zc, lpc, gc = z0, lp0, grad0
    logw = torch.zeros_like(lp0)
    turning = torch.zeros(n, dtype=torch.bool, device=z0.device)
    diverging = torch.zeros_like(turning)
    acc_sum = torch.zeros_like(lp0)
    n_leaf = torch.zeros(n, dtype=torch.int64, device=z0.device)
    for depth in range(max_depth):
        running = ~turning & ~diverging
        if depth and not bool(running.any()):
            break
        forward = _uniform(generator, n, z0) < 0.5
        u_picks = _uniform(generator, (1 << depth, n), z0)
        z = torch.where(forward[:, None], zr, zl)
        p = torch.where(forward[:, None], pr, -pl)
        g = torch.where(forward[:, None], gr, gl)
        s_zc, s_lpc, s_gc = z, torch.zeros_like(lp0), g
        s_logw = torch.full_like(lp0, -math.inf)
        s_turn, s_div = torch.zeros_like(turning), torch.zeros_like(turning)
        # the checkpoint stack: even leaves' states, shared slot pointer
        z_stack, p_stack = [None] * (max_depth + 1), [None] * (max_depth + 1)
        sp = 0
        for i in range(1 << depth):
            live = running & ~s_turn & ~s_div
            if i and not bool(live.any()):
                break
            z_n, p_n, g_n, lp_n = leapfrog(z, p, g)
            lw = h0 - (0.5 * torch.sum(p_n * p_n, dim=-1) - lp_n)
            lw = torch.where(torch.isnan(lw), torch.full_like(lw, -math.inf),
                             lw)
            logw_new = torch.logaddexp(s_logw, lw)
            take = live & (torch.log(u_picks[i]) < lw - logw_new)
            if i % 2 == 0:
                z_stack[sp], p_stack[sp] = z_n, p_n
                sp += 1
            else:
                t_ones = _trailing_ones(i, max_depth + 1)
                for k in range(1, t_ones + 1):
                    s_turn = s_turn | (live & _is_uturn(
                        z_stack[sp - k], p_stack[sp - k], z_n, p_n))
                sp -= t_ones - 1
            s_div = torch.where(live, lw < -max_delta_energy, s_div)
            z, p, g = (_where(live, new, old)
                       for new, old in ((z_n, z), (p_n, p), (g_n, g)))
            s_zc, s_lpc, s_gc = (_where(take, new, old) for new, old in (
                (z_n, s_zc), (lp_n, s_lpc), (g_n, s_gc)))
            s_logw = _where(live, logw_new, s_logw)
            acc_sum = acc_sum + torch.where(
                live, torch.exp(torch.clamp(lw, max=0.0)),
                torch.zeros_like(lw))
            n_leaf = n_leaf + live.to(torch.int64)
        ok = running & ~s_turn & ~s_div
        u_swap = _uniform(generator, n, z0)
        swap = ok & (torch.log(u_swap) < s_logw - logw)
        left, right = ok & ~forward, ok & forward
        zl, pl, gl = (_where(left, new, old)
                      for new, old in ((z, zl), (-p, pl), (g, gl)))
        zr, pr, gr = (_where(right, new, old)
                      for new, old in ((z, zr), (p, pr), (g, gr)))
        zc, lpc, gc = (_where(swap, new, old) for new, old in (
            (s_zc, zc), (s_lpc, lpc), (s_gc, gc)))
        logw = torch.where(ok, torch.logaddexp(logw, s_logw), logw)
        turning = torch.where(
            running, s_turn | (ok & _is_uturn(zl, pl, zr, pr)), turning)
        diverging = torch.where(running, s_div, diverging)
    accept_stat = acc_sum / torch.clamp(n_leaf, min=1).to(acc_sum.dtype)
    return zc, lpc, gc, accept_stat, n_leaf


def nuts_step(state: ChainState, generator, value_and_grad_fn: Callable,
              max_depth: int = 8, max_delta_energy: float = 1000.0,
              target_acceptance: float = 0.8,
              adaptation_rate: float = 0.05) -> ChainState:
    """One NUTS transition of the whole batch (:func:`nuts_trajectory`);
    ``n_accept`` gains each particle's mean Metropolis ratio, so the
    recorded acceptance stays comparable with the other kernels, and the
    evaluation count the leapfrogs the particles took."""
    x, lp, grad, accept_stat, n_leaf = nuts_trajectory(
        generator, state.x, state.log_prob, state.grad, value_and_grad_fn,
        state.step_size, max_depth=max_depth,
        max_delta_energy=max_delta_energy)
    return ChainState(
        x=x, log_prob=lp,
        step_size=adapt_step_size(state.step_size, torch.mean(accept_stat),
                                  target_acceptance, adaptation_rate,
                                  max_log_step=2.3),
        n_accept=state.n_accept + accept_stat, grad=grad,
        n_evals=state.n_evals + torch.sum(n_leaf))


def stretch_step(state: ChainState, generator, log_prob_fn: Callable,
                 a: float = 2.0) -> ChainState:
    """Goodman-Weare stretch move with red-black halves: each half proposes
    against a partner drawn from the other half, so both update as
    batched operations; an odd n splits unevenly (the first half n // 2).
    Draws per half, in order: the partners, the stretch uniforms, the
    accept uniforms."""
    n, d = state.x.shape
    half = n // 2
    x, lp, n_accept = state.x, state.log_prob, state.n_accept
    lo, hi = math.sqrt(1 / a), math.sqrt(a)
    for (m0, m1), (o0, o1) in (((0, half), (half, n)),
                               ((half, n), (0, half))):
        n_move = m1 - m0
        pick = _randint(generator, 0, o1 - o0, (n_move,), x)
        u = _uniform(generator, n_move, x)
        z = (u * (hi - lo) + lo) ** 2
        partners = x[o0 + pick]
        x_move = x[m0:m1]
        x_prop = partners + z[:, None] * (x_move - partners)
        lp_prop = log_prob_fn(x_prop)
        log_alpha = (d - 1) * torch.log(z) + lp_prop - lp[m0:m1]
        log_alpha = torch.where(torch.isnan(log_alpha),
                                torch.full_like(log_alpha, -math.inf),
                                log_alpha)
        accept = torch.log(_uniform(generator, n_move, x)) < log_alpha
        x = torch.cat([x[:m0], torch.where(accept[:, None], x_prop, x_move),
                       x[m1:]])
        lp = torch.cat([lp[:m0], torch.where(accept, lp_prop, lp[m0:m1]),
                        lp[m1:]])
        n_accept = torch.cat([n_accept[:m0],
                              n_accept[m0:m1] + accept.to(n_accept.dtype),
                              n_accept[m1:]])
    return ChainState(x=x, log_prob=lp, step_size=state.step_size,
                      n_accept=n_accept, grad=state.grad,
                      n_evals=state.n_evals + n)


def lag1_autocorr_time(s1, s2, c1, n_steps: int) -> torch.Tensor:
    """AR(1) integrated autocorrelation time from deviation sums."""
    m = n_steps + 1
    mean = s1 / m
    var = s2 / m - mean**2
    cov1 = c1 / n_steps - mean**2
    rho = torch.where(var > 1e-12, cov1 / torch.clamp(var, min=1e-12),
                      torch.ones_like(var))
    rho_dim = torch.clamp(torch.mean(rho, dim=0), -0.9999, 0.9999)
    tau_dim = (1 + rho_dim) / (1 - rho_dim)
    return torch.mean(torch.clamp(tau_dim, min=1.0))


def chain_mixing_ratio(x0, s1, s2, n_steps: int) -> torch.Tensor:
    """Worst-dimension within/pooled variance ratio, in [0, 1]."""
    m = n_steps + 1
    dev_mean = s1 / m
    within = torch.mean(s2 / m - dev_mean**2, dim=0)
    walker_means = x0 + dev_mean
    grand = torch.mean(walker_means, dim=0)
    between = torch.mean((walker_means - grand) ** 2, dim=0)
    pooled = within + between
    ratio = torch.where(pooled > 1e-12,
                        within / torch.clamp(pooled, min=1e-12),
                        torch.ones_like(pooled))
    return torch.clamp(torch.min(ratio), 0.0, 1.0)


def run_chain(step_fn: Callable[[ChainState], ChainState],
              state: ChainState, n_steps: int, store_chain: bool = False):
    """Run ``n_steps`` steps, tracking the online AR(1)/mixing sums.

    Returns ``(final_state, ChainStats)``, and with ``store_chain`` the
    positions after every step, ``(n_steps, n, d)``, as a third value (the
    JAX package's ``store_chain=True``; its last step is the final state).
    """
    x0 = state.x
    prev_d = torch.zeros_like(x0)
    s1, s2, c1 = prev_d.clone(), prev_d.clone(), prev_d.clone()
    chain = (torch.empty((n_steps, *x0.shape), dtype=x0.dtype,
                         device=x0.device) if store_chain else None)
    for i in range(n_steps):
        state = step_fn(state)
        if store_chain:
            chain[i] = state.x
        delta = state.x - x0
        s1 = s1 + delta
        s2 = s2 + delta**2
        c1 = c1 + delta * prev_d
        prev_d = delta
    stats = ChainStats(tau=lag1_autocorr_time(s1, s2, c1, n_steps),
                       mixing=chain_mixing_ratio(x0, s1, s2, n_steps))
    return (state, stats, chain) if store_chain else (state, stats)

