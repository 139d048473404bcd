"""Particle resampling (counterpart of ``aspire_tpu/ops/resampling.py``).

Each scheme returns ``(n_out,)`` indices into the particle array. The
uniforms come from an explicit ``torch.Generator`` on the weights' device;
``systematic_resample`` also takes its offset ``u`` directly, so a test can
feed it the same number as the JAX package.

On a mesh (:mod:`aspire_tpu_torch.parallel.mesh`) a resampling is two
steps: the global index, computed by every rank alike from the gathered
log-weights (the same generator state on every rank gives the same
index), and a movement step that brings each rank the rows of its block of
the output: the ring (:func:`ring_move`) or bucketed all-to-all
(:func:`alltoall_move`). Both give ``data[idx]`` bit for bit.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as M


def _normalized_weights(log_w: torch.Tensor) -> torch.Tensor:
    return torch.exp(log_w - torch.logsumexp(log_w, dim=0))


#: the row length of :func:`rowwise_cumsum`
SCAN_ROW = 1024


def rowwise_cumsum(w: torch.Tensor) -> torch.Tensor:
    """The running sum of a 1-D tensor in one fixed order: within rows of
    ``SCAN_ROW``, then over the rows' totals. torch scans a 1-D CUDA tensor
    with CUB, whose float sum order changes from run to run (CUB's
    decoupled look-back), so a fixed seed would not repeat a resampling;
    torch scans along the last dim of a 2-D tensor of two rows or more in
    one order."""
    n = w.shape[0]
    m = max(-(-n // SCAN_ROW), 2)
    rows = torch.nn.functional.pad(w, (0, m * SCAN_ROW - n)).reshape(
        m, SCAN_ROW).cumsum(1)
    totals = rows[:, -1]
    ends = torch.stack([totals, totals]).cumsum(1)[0]
    offsets = torch.nn.functional.pad(ends[:-1], (1, 0))
    return (rows + offsets[:, None]).reshape(-1)[:n]


def _cdf(log_w: torch.Tensor) -> torch.Tensor:
    w = _normalized_weights(log_w)
    cdf = rowwise_cumsum(w) if w.is_cuda else torch.cumsum(w, dim=0)
    return cdf / cdf[-1]


def _uniform(generator, shape, log_w):
    return torch.rand(shape, generator=generator, dtype=log_w.dtype,
                      device=log_w.device)


def systematic_resample(generator, log_w: torch.Tensor,
                        n_out: int | None = None, u=None) -> torch.Tensor:
    """One uniform offset, ``n_out`` evenly spaced points."""
    n = log_w.shape[0]
    n_out = n_out or n
    if u is None:
        u = _uniform(generator, (), log_w)
    pts = (u + torch.arange(n_out, dtype=log_w.dtype, device=log_w.device)
           ) / n_out
    idx = torch.searchsorted(_cdf(log_w), pts, side="left")
    return torch.clamp(idx, 0, n - 1)


def stratified_resample(generator, log_w: torch.Tensor,
                        n_out: int | None = None) -> torch.Tensor:
    """One uniform per stratum."""
    n = log_w.shape[0]
    n_out = n_out or n
    u = _uniform(generator, (n_out,), log_w)
    pts = (u + torch.arange(n_out, dtype=log_w.dtype, device=log_w.device)
           ) / n_out
    idx = torch.searchsorted(_cdf(log_w), pts, side="left")
    return torch.clamp(idx, 0, n - 1)


def multinomial_resample(generator, log_w: torch.Tensor,
                         n_out: int | None = None) -> torch.Tensor:
    n_out = n_out or log_w.shape[0]
    return torch.multinomial(_normalized_weights(log_w), n_out,
                             replacement=True, generator=generator)


def residual_resample(generator, log_w: torch.Tensor,
                      n_out: int | None = None) -> torch.Tensor:
    """Deterministic floor counts plus a multinomial remainder."""
    n = log_w.shape[0]
    n_out = n_out or n
    w = _normalized_weights(log_w)
    counts = torch.floor(n_out * w).to(torch.int64)
    n_det = torch.sum(counts)
    ends = torch.cumsum(counts, dim=0)
    slot = torch.arange(n_out, device=log_w.device)
    det_idx = torch.clamp(torch.searchsorted(ends, slot, side="right"),
                          0, n - 1)
    resid = torch.clamp(n_out * w - counts, min=1e-38)
    mult_idx = torch.multinomial(resid, n_out, replacement=True,
                                 generator=generator)
    return torch.where(slot < n_det, det_idx, mult_idx)


_SCHEMES = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}


def get_resampler(method: str):
    try:
        return _SCHEMES[method]
    except KeyError:
        raise ValueError(
            f"Unknown resampling method '{method}'. "
            f"Choose from {sorted(_SCHEMES)}"
        ) from None


# -- the collective schedules on a mesh -----------------------------------


def _out_rows(mesh, n_out: int) -> int:
    if n_out % mesh.size:
        raise ValueError(
            f"n_out ({n_out}) must be divisible by the mesh size "
            f"({mesh.size}) — each shard emits n_out/S rows.")
    return n_out // mesh.size


def ring_move(idx: torch.Tensor, block: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of ``data[idx]`` by the ring, ``block`` its rows of
    ``data``; ``idx`` is the global index, the same on every rank. The
    blocks pass round the mesh, and each rank copies the rows it needs
    from the block it holds: ``S - 1`` shifts (the JAX package's loop
    shifts once more, bringing each block home)."""
    out_rows = _out_rows(mesh, idx.shape[0])
    idx_mine = idx[mesh.rank * out_rows:(mesh.rank + 1) * out_rows]
    chunk = block.shape[0]
    out = block.new_zeros((out_rows, *block.shape[1:]))
    held = block
    for r in range(mesh.size):
        src = (mesh.rank - r) % mesh.size  # whose block is held
        rows = idx_mine - src * chunk
        want = (rows >= 0) & (rows < chunk)
        picked = held[torch.clamp(rows, 0, chunk - 1)]
        out = torch.where(want.reshape(-1, *[1] * (block.dim() - 1)),
                          picked, out)
        if r + 1 < mesh.size:
            held = M.shift(held, mesh, 1)
    return out


def _default_cap(out_rows: int, n_shards: int) -> int:
    """The rows a (source, destination) pair may exchange by default: 4x a
    balanced resampling's ``out_rows / S``, at least 16, at most
    ``out_rows`` (the JAX package's)."""
    return min(out_rows, max(4 * out_rows // n_shards, 16))


def alltoall_move(idx: torch.Tensor, block: torch.Tensor, mesh,
                  cap: int | None = None, on_device: bool = False
                  ) -> tuple[torch.Tensor, bool | torch.Tensor]:
    """This rank's rows of ``data[idx]`` by one all-to-all of per-(source,
    destination) buckets of ``cap`` rows, and whether the ring was taken
    instead. Each source sends the rows a destination wants from its block
    in the destination's row order; the destination places them by their
    running rank per source. Every rank counts the rows of every pair from
    the global index alike, so where any pair passes ``cap`` every rank
    takes the ring on the same index (the JAX package's overflow fallback),
    and no collective decides it.

    Where ``cap`` is at least the rows a rank emits (the default at 2 and 4
    ranks), no pair can pass it and nothing is counted. Otherwise the
    decision is a host read of the pair counts, or with ``on_device`` (a
    rung a CUDA graph captures, which allows no read) a flag on the device:
    both schedules run on the same index and the flag selects the ring's
    rows, the JAX package's ``lax.cond`` on its ``pmax`` with both branches
    paid for. The flag, a 0-d bool tensor, is then what is returned."""
    chunk, s, me = block.shape[0], mesh.size, mesh.rank
    out_rows = _out_rows(mesh, idx.shape[0])
    cap = min(int(cap if cap is not None else _default_cap(out_rows, s)),
              out_rows)
    src_of = (idx // chunk).reshape(s, out_rows)  # [dst, j]: source rank
    overflow = False
    if cap < out_rows:
        pair = torch.stack([(src_of == t).sum(1) for t in range(s)])
        if on_device:
            overflow = pair.max() > cap
        elif int(pair.max()) > cap:
            return ring_move(idx, block, mesh), True
    sends = []
    for t in range(s):
        idx_t = idx[t * out_rows:(t + 1) * out_rows]
        mine = src_of[t] == me
        # stable compaction: the rows for t, in t's row order
        order = torch.argsort((~mine).to(torch.int8), stable=True)
        rows = torch.where(mine, idx_t - me * chunk,
                           torch.zeros_like(idx_t))[order]
        sends.append(block[rows[:cap]])
    recv = M.all_to_all(torch.stack(sends), mesh)  # [src, cap, ...]
    src = src_of[me]
    onehot = src[:, None] == torch.arange(s, device=src.device)[None, :]
    rank = torch.gather(torch.cumsum(onehot.to(torch.int64), 0), 1,
                        src[:, None])[:, 0] - 1
    out = recv[src, torch.clamp(rank, max=cap - 1)]
    if isinstance(overflow, torch.Tensor):
        ring = ring_move(idx, block, mesh)
        out = torch.where(overflow, ring, out)
    return out, overflow


def global_index(generator, log_w: torch.Tensor, mesh,
                 method: str = "systematic",
                 n_out: int | None = None) -> torch.Tensor:
    """The resampling index of the whole population from this rank's
    log-weights: every rank gathers them and draws the same index."""
    lw = M.all_gather_rows(log_w, mesh)
    return get_resampler(method)(generator, lw, n_out or lw.shape[0])


def ring_resample_matrix(generator, log_w: torch.Tensor, data: torch.Tensor,
                         mesh, axis_name: str = "data",
                         method: str = "systematic",
                         n_out: int | None = None) -> torch.Tensor:
    """Resample a row-sharded ``(n, cols)`` matrix over the mesh by the
    ring: ``log_w`` and ``data`` are this rank's rows; returns its ``n_out
    / S`` rows of ``data[idx]`` (``n_out`` defaults to ``n``), ``idx`` the
    index :func:`get_resampler` draws on the gathered weights."""
    del axis_name  # one axis
    n_out = n_out or log_w.shape[0] * mesh.size
    _out_rows(mesh, n_out)
    idx = global_index(generator, log_w, mesh, method, n_out)
    return ring_move(idx, data, mesh)


def alltoall_resample_matrix(generator, log_w: torch.Tensor,
                             data: torch.Tensor, mesh,
                             axis_name: str = "data",
                             method: str = "systematic",
                             cap: int | None = None,
                             n_out: int | None = None) -> torch.Tensor:
    """:func:`ring_resample_matrix` by bucketed all-to-all
    (:func:`alltoall_move`): the same rows; where a pair's rows pass
    ``cap``, the ring on the same index."""
    del axis_name
    n_out = n_out or log_w.shape[0] * mesh.size
    _out_rows(mesh, n_out)
    idx = global_index(generator, log_w, mesh, method, n_out)
    return alltoall_move(idx, data, mesh, cap)[0]
