"""aspire_tpu_torch's staged coupling pass (D1-D3) against the TPU
prototypes in ``benchmarks/dev/``.

The dev scripts run a TPU benchmark when imported, so their kernel bodies
are taken out with ``ast`` and run in this file's own
``pl.pallas_call(..., interpret=True)``, in a namespace that supplies what
the scripts define at module level. The same weights and float32 inputs
(numpy, from a seed) go through the port's plain schedules, at the JAX
package's own kernel bound (rtol 1e-3, atol 1e-4); float64 cases hold the
plain schedules to ``Coupling.forward_plain`` at 1e-10.
"""

import ast
import functools
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from aspire_tpu.flows.architectures import Coupling as JCoupling
from aspire_tpu.ops import fused_coupling as jfc
from aspire_tpu_torch.flows.architectures import Coupling
from aspire_tpu_torch.flows.bijectors import rational_quadratic_spline
from aspire_tpu_torch.ops import fused_coupling as FC
from aspire_tpu_torch.ops import staged_coupling as SC
from aspire_tpu_torch.utils import flow_params_from_jax

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEV = ROOT / "benchmarks" / "dev"
# The dev scripts' flow: Coupling(dims=4, n_layers=4, n_hidden=(64, 64),
# transformer="rqs"), 8 bins, tail bound 5.
L, D = 4, 4
TOL = dict(rtol=1e-3, atol=1e-4)


def _extract(script: str, names: list, namespace: dict) -> dict:
    """Execute only the named top-level functions of a dev script."""
    tree = ast.parse((DEV / script).read_text())
    funcs = [node for node in tree.body
             if isinstance(node, ast.FunctionDef) and node.name in names]
    assert sorted(f.name for f in funcs) == sorted(names)
    code = compile(ast.Module(body=funcs, type_ignores=[]),
                   str(DEV / script), "exec")
    exec(code, namespace)
    return namespace


@pytest.fixture(scope="module")
def flow():
    jarch = JCoupling(dims=D, n_layers=L, n_hidden=(64, 64),
                      transformer="rqs", dtype="float32")
    params = jarch.init(jax.random.key(0))
    params = jax.tree.map(
        lambda p: p + 0.1 * jax.random.normal(jax.random.key(1), p.shape,
                                              p.dtype), params)
    prepared = jfc.prepare_params(jarch, params)
    namespace = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, arch=jarch,
                     prepared=prepared, L=L, n_dense=len(prepared) // 2, d=D)
    tarch = Coupling(dims=D, n_layers=L, n_hidden=(64, 64),
                     transformer="rqs")
    return namespace, tarch, flow_params_from_jax(params, dtype="float32")


def _x(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, D)).astype(np.float32)


def _interpret(kernel, weights, x: np.ndarray, tile: int):
    """A dev kernel body over (d, tile) blocks, as its script calls it."""
    n, d = x.shape
    zt, ld = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((d, n), jnp.float32),
                   jax.ShapeDtypeStruct((1, n), jnp.float32)),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((d, tile), lambda i: (0, i))] + [
            pl.BlockSpec(w.shape, lambda i, nd=w.ndim: (0,) * nd)
            for w in weights],
        out_specs=(pl.BlockSpec((d, tile), lambda i: (0, i)),
                   pl.BlockSpec((1, tile), lambda i: (0, i))),
        interpret=True,
    )(jnp.asarray(x).T, *weights)
    return np.asarray(zt.T), np.asarray(ld[0])


def _close(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), b, **TOL)


def test_interleaved_matches_d1(flow):
    """D1 (``interleave_ab.py::_interleaved_kernel``) against the port's
    D1 wrapper on a CPU tensor (its plain version) and the plain schedule
    at the prototype's sub-tile."""
    namespace, tarch, tparams = flow
    ns = _extract("interleave_ab.py", ["_mm", "_spline", "_interleaved_kernel"],
                  dict(namespace, fc=jfc))
    x = _x(1024, 1)
    ref = _interpret(functools.partial(ns["_interleaved_kernel"], ns["arch"],
                                       ns["n_dense"]), ns["prepared"], x, 512)
    _close(SC.interleaved_apply(tarch, tparams, torch.as_tensor(x)), ref)
    _close(SC.staged_plain(tarch, tparams, torch.as_tensor(x), 2, 256), ref)


@pytest.mark.parametrize("q", [2, 3, 4, 8])
def test_staged_plain_matches_d2(flow, q):
    """D2 (``quad_interleave_ab.py::_q_kernel``) at the same Q, tiles of
    512 (768 for Q = 3) particles."""
    namespace, tarch, tparams = flow
    ns = _extract("quad_interleave_ab.py", ["_q_kernel"],
                  dict(namespace, fc=jfc))
    tile = 768 if q == 3 else 512
    x = _x(2 * tile, q)
    ref = _interpret(functools.partial(ns["_q_kernel"], q), ns["prepared"],
                     x, tile)
    _close(SC.staged_plain(tarch, tparams, torch.as_tensor(x), q, tile // q),
           ref)
    _close(SC.q_apply(tarch, tparams, torch.as_tensor(x), q), ref)


@pytest.mark.parametrize("micro", [False, True])
def test_paired_plain_matches_d3(flow, micro):
    """D3 (``packed_ab.py::_packed_kernel`` with its block-diagonal
    weights), with ``micro`` through the script's ``rqs_micro`` in place
    of ``fc._rqs_rows`` (in a copy of the module's namespace)."""
    namespace, tarch, tparams = flow
    fc = types.SimpleNamespace(**vars(jfc))
    ns = _extract("packed_ab.py",
                  ["packed_weights", "_spline", "_packed_kernel", "rqs_micro"],
                  dict(namespace, fc=fc))
    if micro:
        fc._rqs_rows = ns["rqs_micro"]
    x = _x(1024, 10 + micro)
    ref = _interpret(ns["_packed_kernel"], ns["packed_weights"](), x, 512)
    xt = torch.as_tensor(x)
    _close(SC.paired_plain(tarch, tparams, xt, 256, micro), ref)
    _close(SC.packed_apply(tarch, tparams, xt, micro), ref)


def _flow64(seed: int = 0):
    arch = Coupling(dims=D, n_layers=L, n_hidden=(16, 16), transformer="rqs",
                    dtype="float64")
    gen = torch.Generator().manual_seed(seed)
    params = arch.init(gen)
    for net in params["layers"]:
        for layer in net["layers"]:
            for k in ("w", "b"):
                layer[k] = layer[k] + 0.3 * torch.randn(
                    layer[k].shape, generator=gen, dtype=torch.float64)
    return arch, params


_VARIANTS = {
    "q2": lambda a, p, x: SC.staged_plain(a, p, x, 2, SC.sub_tile(a, 2)),
    "q3": lambda a, p, x: SC.staged_plain(a, p, x, 3, SC.sub_tile(a, 3)),
    "q4": lambda a, p, x: SC.staged_plain(a, p, x, 4, SC.sub_tile(a, 4)),
    "q8": lambda a, p, x: SC.staged_plain(a, p, x, 8, 16),
    "paired": lambda a, p, x: SC.paired_plain(a, p, x, 64),
    "paired_micro": lambda a, p, x: SC.paired_plain(a, p, x, 48, micro=True),
}


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
@pytest.mark.parametrize("n", [1000, 1536])
def test_plain_schedules_equal_forward_plain_f64(variant, n):
    """Every schedule is the coupling density pass: float64 against
    ``Coupling.forward_plain`` at 1e-10, with a ragged last tile."""
    arch, params = _flow64()
    x = torch.as_tensor(2.0 * np.random.default_rng(n).normal(size=(n, D)))
    z, ld = _VARIANTS[variant](arch, params, x)
    z0, ld0 = arch.forward_plain(params, x)
    assert z.shape == (n, D) and ld.shape == (n,)
    torch.testing.assert_close(z, z0, rtol=0, atol=1e-10)
    torch.testing.assert_close(ld, ld0, rtol=0, atol=1e-10)


@pytest.mark.parametrize("inverse", [False, True])
def test_rqs_micro_is_the_spline_f64(inverse):
    """``rqs_micro`` is ``rational_quadratic_spline`` with another
    rounding: equal in float64 to 1e-10."""
    rng = np.random.default_rng(7 + inverse)
    K = 8
    v = torch.as_tensor(6.0 * rng.normal(size=(4000,)))
    raw = torch.as_tensor(2.0 * rng.normal(size=(4000, 3 * K - 1)))
    y, ld = SC.rqs_micro(v, raw, K, 5.0, inverse)
    y0, ld0 = rational_quadratic_spline(v, raw, K, 5.0, inverse)
    torch.testing.assert_close(y, y0, rtol=0, atol=1e-10)
    torch.testing.assert_close(ld, ld0, rtol=0, atol=1e-10)


def test_rqs_micro_nan_where_every_width_underflows():
    """The hazard of dropping the max subtraction: raw widths all below
    about -104 underflow ``exp`` to 0 in float32 (below about -87 only
    denormals are left) and the row is 0 / 0; the reference spline stays
    finite there."""
    K = 8
    raw = torch.zeros(1, 3 * K - 1)
    raw[0, :K] = -110.0
    v = torch.tensor([0.3])
    y, _ = SC.rqs_micro(v, raw, K, 5.0, inverse=True)
    y0, _ = rational_quadratic_spline(v, raw, K, 5.0, inverse=True)
    assert torch.isnan(y).all() and torch.isfinite(y0).all()


def test_config_table_mirrors_common_cuh():
    """``STAGED_CONFIGS`` is ``ASPIRE_STAGED_CONFIGS``, every S is the
    shared-memory rule's, and every dev-sweep Q is compiled."""
    text = (ROOT / "aspire_tpu_torch" / "csrc" / "common.cuh").read_text()
    body = text[text.index("#define ASPIRE_STAGED_CONFIGS"):]
    rows = re.findall(r"X\(([^)]*)\)", body.split("\n\n")[0])
    parsed = {}
    for row in rows:
        f = [v.strip() for v in row.split(",")]
        parsed[int(f[0])] = (int(f[1]), (int(f[2]), int(f[3])), int(f[4]),
                             int(f[5]), int(f[6]), f[7] == "true",
                             f[8] == "true")
    assert parsed == SC.STAGED_CONFIGS
    for cid, (d, hidden, k, q, s, paired, micro) in parsed.items():
        arch = Coupling(dims=d, n_layers=L, n_hidden=hidden, num_bins=k)
        assert SC.sub_tile(arch, q) == s
        assert SC.staged_config(arch, q, paired, micro) == cid
        assert q * s * SC.buffer_floats(arch) * 4 + FC.weight_bytes(
            arch) <= FC.MAX_SHARED_BYTES
    arch = Coupling(dims=D, n_layers=L, n_hidden=(64, 64))
    assert all(SC.staged_config(arch, q) is not None for q in SC.COMPILED_Q)


def test_launch_refuses_what_is_not_compiled(flow):
    """A Q that is not compiled, or a CPU tensor handed to a launcher,
    raises before anything is built or launched."""
    _, tarch, tparams = flow
    w = FC.prepare_params(tarch, tparams)
    x = torch.as_tensor(_x(64, 0))
    with pytest.raises(ValueError, match="no staged coupling kernel"):
        SC.launch_q(tarch, w, x, 5)
    with pytest.raises(ValueError, match="CUDA"):
        SC.launch_q(tarch, w, x, 4)
    small = Coupling(dims=D, n_layers=L, n_hidden=(16, 16))
    with pytest.raises(ValueError, match="no staged coupling kernel"):
        SC.launch_packed(small, w, x)


def test_wrappers_on_cpu_run_plain_and_launch_nothing(flow):
    _, tarch, tparams = flow
    counters = (SC.interleaved_launches, SC.q_launches, SC.packed_launches)
    for c in counters:
        c.reset()
    x = torch.as_tensor(_x(300, 3))
    z0, ld0 = tarch.forward_plain(tparams, x)
    outs = [SC.interleaved_apply(tarch, tparams, x),
            SC.q_apply(tarch, tparams, x, 3),
            SC.packed_apply(tarch, tparams, x)]
    for z, ld in outs:
        torch.testing.assert_close(z, z0, **TOL)
        torch.testing.assert_close(ld, ld0, **TOL)
    assert [c.count for c in counters] == [0, 0, 0]
