"""Uniforms from Philox4x32-10 keyed by a seed pair (D4).

Counterpart of ``benchmarks/dev/prng_probe.py::kernel``, which draws the
TPU's on-core random bits after ``prng_seed(seed0, seed1)`` and converts
each word as ``u = (bits >> 8) * 2^-24 + 2^-25``. The TPU's bits cannot be
reproduced: here element ``e`` takes word ``e % 4`` of Philox4x32-10 for
counter ``(e // 4 low word, e // 4 high word, 0, 0)`` and key ``(seed0,
seed1)`` (the chain kernel's generator,
:func:`~aspire_tpu_torch.ops.fused_mutation.philox4x32_10`), with the
probe's conversion in float32 on unsigned words. The values lie in
``(0, 1]``: in float32 the largest word rounds to exactly 1.0.

:func:`prng_plain` is the same stream in torch, bit for bit;
:func:`prng_uniforms` launches ``csrc/prng.cu`` for a CUDA device and runs
the plain version for the CPU.
"""

from __future__ import annotations

import math

import torch

from ._build import LaunchCounter, check, load_library
from .fused_mutation import _MASK, philox4x32_10

launches = LaunchCounter()


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """The probe's conversion of 32-bit words (held in int64) to float32."""
    return (bits >> 8).to(torch.float32) * 2.0**-24 + 2.0**-25


def prng_plain(seed, shape, device="cpu") -> torch.Tensor:
    """The uniforms of :func:`prng_uniforms` in plain torch."""
    n = math.prod(shape)
    g = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK, g >> 32, zero, zero,
                          int(seed[0]) & _MASK, int(seed[1]) & _MASK)
    bits = torch.stack(words, dim=1).reshape(-1)[:n]
    return bits_to_uniform(bits).reshape(shape)


def prng_uniforms(seed, shape, device) -> torch.Tensor:
    """``shape`` float32 uniforms of the stream keyed by ``seed``
    (a pair of ints), on ``device``: the CUDA kernel on a CUDA device, the
    plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return prng_plain(seed, shape, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    lib = load_library()
    with torch.cuda.device(out.device):
        code = lib.aspire_prng_uniforms(
            out.data_ptr(), out.numel(), int(seed[0]) & _MASK,
            int(seed[1]) & _MASK,
            torch.cuda.current_stream(out.device).cuda_stream)
    launches.count += 1
    check(code, "uniforms kernel")
    return out
