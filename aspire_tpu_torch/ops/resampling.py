"""Single-device particle resampling (counterpart of the single-device
schemes of ``aspire_tpu/ops/resampling.py``).

Each scheme returns ``(n_out,)`` indices into the particle array. The
uniforms come from an explicit ``torch.Generator`` on the weights' device;
``systematic_resample`` also takes its offset ``u`` directly, so a test can
feed it the same number as the JAX package.
"""

from __future__ import annotations

import torch


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
