"""aspire_tpu_torch's Philox uniforms (D4) against the TPU probe
``benchmarks/dev/prng_probe.py``.

The TPU's on-core bits have no CPU lowering; in Pallas interpret mode
``prng_random_bits`` gives zero bits, so the probe's conversion is
compared at zero bits. The port's stream is checked by its construction
(Philox4x32-10 words, whose known answers ``tests/test_torch_chain.py``
holds), its grid, its moments and its seed dependence.
"""

import ast
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aspire_tpu_torch.ops import fused_mutation as FM
from aspire_tpu_torch.ops import prng

torch.set_num_threads(1)

PROBE = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks" /
         "dev" / "prng_probe.py")


def _probe_kernel():
    tree = ast.parse(PROBE.read_text())
    funcs = [n for n in tree.body
             if isinstance(n, ast.FunctionDef) and n.name == "kernel"]
    ns = {"jax": jax, "jnp": jnp, "pltpu": pltpu}
    exec(compile(ast.Module(body=funcs, type_ignores=[]), str(PROBE),
                 "exec"), ns)
    return ns["kernel"]


def test_conversion_at_zero_bits_matches_probe_interpret():
    out = pl.pallas_call(
        _probe_kernel(),
        out_shape=jax.ShapeDtypeStruct((8, 256), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=pltpu.InterpretParams(),
    )(jnp.asarray([3, 7], jnp.int32))
    ref = np.asarray(out)
    assert (ref == 2.0**-25).all()
    port = prng.bits_to_uniform(torch.zeros((8, 256), dtype=torch.int64))
    np.testing.assert_array_equal(port.numpy(), ref)


def test_probe_shape_on_the_grid_in_unit_interval():
    """Seed (3, 7) at the probe's (8, 256): every value is the float32 of
    a grid point (2k + 1) 2^-25, inside (0, 1)."""
    u = prng.prng_plain((3, 7), (8, 256)).double()
    assert u.dtype == torch.float64 and u.shape == (8, 256)
    assert bool(((u > 0) & (u < 1)).all())
    low = u < 0.5
    # Below 1/2 float32 holds the grid exactly (odd multiples of 2^-25);
    # above it rounds them to multiples of 2^-24.
    s = u[low] * 2.0**25
    assert bool((s == s.round()).all()) and bool((s.round() % 2 == 1).all())
    s = u[~low] * 2.0**24
    assert bool((s == s.round()).all())


def test_counter_and_key_layout():
    """Element e is word e % 4 of Philox4x32-10 at counter (e // 4, 0, 0,
    0) and key (seed0, seed1), converted as the probe does."""
    seed = (123456789, -5)
    u = prng.prng_plain(seed, (37,)).numpy()
    for e in (0, 1, 2, 3, 4, 17, 36):
        c = [torch.tensor([v], dtype=torch.int64) for v in (e // 4, 0, 0, 0)]
        words = FM.philox4x32_10(*c, seed[0] & 0xFFFFFFFF,
                                 seed[1] & 0xFFFFFFFF)
        want = prng.bits_to_uniform(words[e % 4])
        assert u[e] == float(want[0])


def test_moments_within_five_sigma():
    n = 1 << 16
    u = prng.prng_plain((3, 7), (n,)).double()
    assert abs(float(u.mean()) - 0.5) < 5 * math.sqrt(1 / 12 / n)
    var_sd = math.sqrt((1 / 80 - 1 / 144) / n)
    assert abs(float(u.var()) - 1 / 12) < 5 * var_sd


def test_seeds_give_different_streams():
    a = prng.prng_plain((3, 7), (4096,))
    b = prng.prng_plain((3, 8), (4096,))
    c = prng.prng_plain((7, 3), (4096,))
    assert float((a == b).double().mean()) < 0.01
    assert float((a == c).double().mean()) < 0.01
    assert torch.equal(a, prng.prng_plain((3, 7), (4096,)))


def test_cpu_device_runs_plain_and_launches_nothing():
    prng.launches.reset()
    u = prng.prng_uniforms((3, 7), (5, 7), "cpu")
    assert torch.equal(u, prng.prng_plain((3, 7), (5, 7)))
    assert prng.launches.count == 0
    with pytest.raises(ValueError, match="unsupported device"):
        prng.prng_uniforms((3, 7), (4,), "meta")
