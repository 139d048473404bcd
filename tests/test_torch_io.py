"""HDF5 files between ``aspire_tpu_torch`` and the JAX package, both ways.

Every piece of a run file is written by one package and read by the
other, then the reverse: dicts, pytrees, shard arrays, state bytes,
histories, samples, transforms and flows (nsf-tpu, realnvp, maf-rqs, maf
and the CNF), the flows' ``log_prob`` held within 1e-10 in float64 and
rtol 1e-5 in float32. Flows are made with perturbed parameters and
fitted data transforms, not trained: the layout is what is tested.
"""

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import history as jhistory
from aspire_tpu import io as jio
from aspire_tpu import samples as jsamples
from aspire_tpu import transforms as jtransforms
from aspire_tpu.flows import Flow as JFlow
from aspire_tpu.flows import FlowMatching as JFlowMatching
from aspire_tpu_torch import history as thistory
from aspire_tpu_torch import io as tio
from aspire_tpu_torch import samples as tsamples
from aspire_tpu_torch import transforms as ttransforms
from aspire_tpu_torch.flows import Flow as TFlow
from aspire_tpu_torch.flows import FlowMatching as TFlowMatching

torch.set_num_threads(1)

D = 3
NAMES = [f"x_{i}" for i in range(D)]
BOUNDS = {p: [-6.0, 8.0] for p in NAMES}
WRITERS = ("jax", "torch")
F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-5, atol=1e-6)


def _x(n=64, seed=0):
    return 1.0 + 1.3 * np.random.default_rng(seed).normal(size=(n, D))


def _same(a, b):
    """Values equal after a round trip (arrays by value, nested)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray) or (isinstance(a, list) and a and all(
            isinstance(v, (int, float)) for v in a)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


# -- dicts, pytrees, shard arrays, state bytes ---------------------------------

DICT = {
    "none": None, "text": "nsf-tpu", "flag": True, "count": 7, "scale": 0.25,
    "floats": [1.0, 2.5], "names": ["a", "bb"], "empty": {},
    "mixed": [{"a": 1}, None], "array": np.arange(6.0).reshape(2, 3),
    "nested": {"deeper": {"x": 1.5, "y": None}, "n": [3, 4]},
}


@pytest.mark.parametrize("writer", WRITERS)
def test_dicts_cross_both_ways(tmp_path, writer):
    path = tmp_path / "d.h5"
    save, load = ((jio.save_dict_to_hdf5, tio.load_dict_from_hdf5)
                  if writer == "jax" else
                  (tio.save_dict_to_hdf5, jio.load_dict_from_hdf5))
    with h5py.File(path, "w") as f:
        save(f, "cfg", DICT)
    with h5py.File(path, "r") as f:
        got = load(f, "cfg")
    _same(DICT, got)


@pytest.mark.parametrize("writer", WRITERS)
def test_pytrees_keep_the_jax_leaf_order(tmp_path, writer):
    """Leaves in ``jax.tree_util.tree_flatten``'s order (dict keys sorted,
    lists in order), whatever the dict's own order, both ways."""
    rng = np.random.default_rng(1)
    tree = {"layers": [{"w": rng.normal(size=(2, 3)), "b": rng.normal(size=3)}
                       for _ in range(2)], "alpha": rng.normal(size=(1,))}
    assert [a.shape for a in tio.tree_flatten(tree)] == [
        a.shape for a in jax.tree_util.tree_leaves(tree)]
    assert tio.treedef_string(tree) == str(jax.tree_util.tree_structure(tree))
    like_t = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.float64),
                          tree)
    path = tmp_path / "p.h5"
    with h5py.File(path, "w") as f:
        if writer == "jax":
            jio.save_pytree_to_hdf5(f, "params", tree)
        else:
            tio.save_pytree_to_hdf5(f, "params", jax.tree.map(
                torch.as_tensor, tree))
    with h5py.File(path, "r") as f:
        got = (tio.load_pytree_from_hdf5(f, "params", like_t)
               if writer == "jax" else
               jio.load_pytree_from_hdf5(f, "params", tree))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with h5py.File(path, "r") as f, pytest.raises(ValueError, match="shape"):
        tio.load_pytree_from_hdf5(f, "params", {
            **like_t, "alpha": torch.zeros(2, dtype=torch.float64)})


@pytest.mark.parametrize("writer", WRITERS)
def test_shard_arrays_and_state_bytes_cross_both_ways(tmp_path, writer):
    arr = np.random.default_rng(2).normal(size=(40, D)).astype(np.float32)
    payload = b"\x00state\xff" * 5
    mod_w, mod_r = (jio, tio) if writer == "jax" else (tio, jio)
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as f:
        mod_w.save_sharded_array(f, "checkpoint/arrays/x",
                                 arr if writer == "jax"
                                 else torch.as_tensor(arr))
        mod_w.save_state_bytes(f, payload)
    with h5py.File(path, "r") as f:
        got = mod_r.load_sharded_array(f, "checkpoint/arrays/x")
        assert mod_r.load_state_bytes(f) == payload
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, arr)


def test_port_file_version_stamp(tmp_path):
    import aspire_tpu_torch

    with tio.AspireFile(tmp_path / "f.h5", "w") as f:
        assert f.attrs["aspire_tpu_version"] == aspire_tpu_torch.__version__


# -- histories and samples -------------------------------------------------------


def _snapshot(pkg, seed, beta):
    rng = np.random.default_rng(seed)
    s = pkg.SMCSamples(x=rng.normal(size=(8, D)), beta=beta,
                       log_likelihood=rng.normal(size=8),
                       log_prior=rng.normal(size=8),
                       log_q=rng.normal(size=8), parameters=NAMES,
                       dtype="float64")
    return s.to_numpy()


def _history(hpkg, spkg):
    h = hpkg.SMCHistory(beta=[0.1, 0.5, 1.0], ess=[10.0, 9.0, 8.0],
                        log_norm_ratio=[-1.0, -0.5, -0.25],
                        log_norm_ratio_var=[0.1, 0.2, 0.3],
                        mcmc_acceptance=[0.3, 0.25, 0.2],
                        lineage_fraction=[1.0, 0.9, 0.8])
    h.sample_history = [_snapshot(spkg, i, b)
                        for i, b in enumerate((0.0, 0.1, 0.5, 1.0))]
    if hpkg is thistory:
        h.mutation_route = ["fused_kernel", "split", "split"]
        h.nonfinite_target = [0, 1, 0]
    return h


@pytest.mark.parametrize("writer", WRITERS)
def test_histories_cross_both_ways(tmp_path, writer):
    hw, sw, hr = ((jhistory, jsamples, thistory) if writer == "jax"
                  else (thistory, tsamples, jhistory))
    h = _history(hw, sw)
    fh = hw.FlowHistory(training_loss=[3.0, 2.0], validation_loss=[3.5, 2.5])
    path = tmp_path / "h.h5"
    with h5py.File(path, "w") as f:
        h.save(f)
        fh.save(f)
    with h5py.File(path, "r") as f:
        got = hr.SMCHistory.load(f)
        gfh = hr.FlowHistory.load(f)
    assert gfh.training_loss == fh.training_loss
    assert gfh.validation_loss == fh.validation_loss
    for name in ("beta", "ess", "log_norm_ratio", "log_norm_ratio_var",
                 "mcmc_acceptance", "lineage_fraction"):
        assert getattr(got, name) == getattr(h, name), name
    # The port's extra fields ride along, and default where absent.
    want = (h.mutation_route, h.nonfinite_target) if writer == "torch" else (
        [], [])
    assert (list(got.mutation_route), list(got.nonfinite_target)) == (
        list(want[0]), list(want[1]))
    assert len(got.sample_history) == 4
    for a, b in zip(h.sample_history, got.sample_history):
        assert a.beta == b.beta
        for f in ("x", "log_likelihood", "log_prior", "log_q"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          np.asarray(getattr(b, f)))


def _samples_sets(pkg):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(24, D))
    dens = {k: rng.normal(size=24) for k in ("log_likelihood", "log_prior",
                                             "log_q")}
    chain = dict(chain_shape=(2, 3, 4), burn_in=1, thin=2)
    pt = pkg.PTMCMCSamples(x=x, betas=np.array([1.0, 0.0]),
                           parameters=NAMES, dtype="float64",
                           move_acceptance=np.array([0.3, 0.4]),
                           swap_acceptance=np.array([0.5]), **chain, **dens)
    return {
        "Samples": pkg.Samples(x=x, parameters=NAMES, dtype="float64",
                               **dens),
        "SMCSamples": pkg.SMCSamples(x=x, beta=0.25, parameters=NAMES,
                                     dtype="float64", log_evidence=-3.5,
                                     **dens),
        "MCMCSamples": pkg.MCMCSamples(x=x, parameters=NAMES,
                                       dtype="float64", **chain, **dens),
        "PTMCMCSamples": pt,
    }


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("flat", [False, True])
def test_samples_cross_both_ways(tmp_path, writer, flat):
    pw, pr = (jsamples, tsamples) if writer == "jax" else (tsamples, jsamples)
    sets = _samples_sets(pw)
    path = tmp_path / "s.h5"
    with h5py.File(path, "w") as f:
        for name, s in sets.items():
            s.save(f, path=name, flat=flat)
    with h5py.File(path, "r") as f:
        got = {name: getattr(pr, name).load(f, path=name) for name in sets}
    for name, s in sets.items():
        g = got[name]
        assert g.parameters == NAMES
        for field in ("x", "log_likelihood", "log_prior", "log_q"):
            np.testing.assert_array_equal(np.asarray(getattr(s, field)),
                                          np.asarray(getattr(g, field)))
        for field in ("beta", "chain_shape", "burn_in", "thin"):
            if hasattr(s, field):
                assert tuple(np.atleast_1d(getattr(g, field))) == tuple(
                    np.atleast_1d(getattr(s, field))), (name, field)
    pt, gpt = sets["PTMCMCSamples"], got["PTMCMCSamples"]
    for field in ("betas", "move_acceptance", "swap_acceptance"):
        np.testing.assert_array_equal(np.asarray(getattr(pt, field)),
                                      np.asarray(getattr(gpt, field)))
    assert float(got["SMCSamples"].log_evidence) == -3.5
    np.testing.assert_allclose(float(got["Samples"].log_evidence),
                               float(sets["Samples"].log_evidence), **F64)


def test_samples_to_dict_and_dataframe_match_jax():
    t, j = _samples_sets(tsamples)["Samples"], _samples_sets(jsamples)[
        "Samples"]
    td, jd = t.to_numpy().to_dict(), j.to_numpy().to_dict()
    assert set(td) <= set(jd) and "device" not in td
    for p in NAMES:
        np.testing.assert_array_equal(np.asarray(td[p]), np.asarray(jd[p]))
    back = tsamples.Samples.from_dict(td)
    np.testing.assert_array_equal(back.x.numpy(), np.asarray(j.x))
    tf, jf = t.to_dataframe(), j.to_dataframe()
    assert list(tf.columns) == list(jf.columns)
    np.testing.assert_array_equal(tf.to_numpy(), jf.to_numpy())


# -- transforms -------------------------------------------------------------------

PERIODIC = {"x_1": [-np.pi, np.pi]}


def _transform_kwargs(name):
    if name == "composite":
        return dict(parameters=NAMES, prior_bounds={**BOUNDS, **PERIODIC},
                    periodic_parameters=["x_1"], bounded_transform="logit",
                    affine_transform=True, bounded_to_unbounded=True,
                    dtype="float64")
    return dict(parameters=NAMES, prior_bounds=BOUNDS,
                bounded_transform="probit", dtype="float64")


def _transform(pkg, name):
    cls = pkg.CompositeTransform if name == "composite" else pkg.FlowTransform
    t = cls(**_transform_kwargs(name),
            **({} if pkg is jtransforms else {"device": "cpu"}))
    t.fit(_x() if pkg is not jtransforms else jnp.asarray(_x()))
    return t


def _jax_flow_precond():
    t = jtransforms.FlowPreconditioningTransform(
        parameters=NAMES, prior_bounds=BOUNDS, bounded_transform="logit",
        dtype="float64", flow_backend="nsf",
        flow_kwargs=dict(architecture="nsf", n_layers=2, n_hidden=(8, 8),
                         dtype="float64"))
    dt = t._make_data_transform()
    dt.fit(jnp.asarray(_x()))
    t._rebuild_flow(dt, None)
    rng = np.random.default_rng(3)
    t._rebuild_flow(dt, jax.tree.map(
        lambda p: p + 0.2 * rng.normal(size=p.shape), t.flow.params))
    return t


def _torch_flow_precond():
    t = ttransforms.FlowPreconditioningTransform(
        parameters=NAMES, prior_bounds=BOUNDS, bounded_transform="logit",
        dtype="float64", flow_backend="nsf", device="cpu",
        flow_kwargs=dict(architecture="nsf", n_layers=2, n_hidden=(8, 8),
                         dtype="float64"))
    dt = t._make_data_transform()
    dt.fit(torch.as_tensor(_x()))
    t._rebuild_flow(dt, None)
    gen = torch.Generator().manual_seed(3)
    t._rebuild_flow(dt, jax.tree.map(
        lambda p: p + 0.2 * torch.randn(p.shape, generator=gen,
                                        dtype=p.dtype), t.flow.params))
    return t


@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", ["composite", "flow", "flow_precond"])
def test_transforms_cross_both_ways(tmp_path, writer, name):
    if name == "flow_precond":
        t = _jax_flow_precond() if writer == "jax" else _torch_flow_precond()
    else:
        t = _transform(jtransforms if writer == "jax" else ttransforms, name)
    path = tmp_path / "t.h5"
    with h5py.File(path, "w") as f:
        t.save(f, "tr")
    with h5py.File(path, "r") as f:
        got = (ttransforms.BaseTransform.load(f, "tr") if writer == "jax"
               else jtransforms.BaseTransform.load(f, "tr"))
    assert type(got).__name__ == type(t).__name__
    x = _x(32, seed=9)
    xw = jnp.asarray(x) if writer == "jax" else torch.as_tensor(x)
    xr = torch.as_tensor(x) if writer == "jax" else jnp.asarray(x)
    for a, b in zip(t.forward(xw), got.forward(xr)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **F64)


def test_flow_preconditioning_checkpoint_payload_is_host_data():
    t = _torch_flow_precond()
    payload = t.checkpoint_payload()
    leaves = tio.tree_flatten(payload)
    assert all(not isinstance(v, torch.Tensor) for v in leaves)
    back = ttransforms.FlowPreconditioningTransform.from_checkpoint_payload(
        payload)
    x = torch.as_tensor(_x(16, seed=4))
    for a, b in zip(t.forward(x), back.forward(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert ttransforms.FlowPreconditioningTransform(
        parameters=NAMES).checkpoint_payload() is None


# -- flows ------------------------------------------------------------------------

FLOWS = {
    "nsf-tpu": dict(architecture="nsf-tpu", n_layers=2, n_hidden=(8, 8)),
    "realnvp": dict(architecture="realnvp", n_layers=2, n_hidden=(8, 8)),
    "maf-rqs": dict(architecture="maf-rqs", n_layers=2, n_hidden=(8, 8)),
    "maf": dict(architecture="maf", n_layers=2, n_hidden=(8, 8)),
    "cnf": dict(n_hidden=(8, 8), n_steps=8),
}


def _perturb(params, seed, make):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: make(
        np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.asarray(p).dtype)), params)


def _flow(pkg, name, dtype):
    x = _x()
    if pkg == "jax":
        dt = jtransforms.FlowTransform(parameters=NAMES, prior_bounds=BOUNDS,
                                       bounded_transform="logit", dtype=dtype)
        dt.fit(jnp.asarray(x, dtype=dtype))
        cls = JFlowMatching if name == "cnf" else JFlow
        flow = cls(dims=D, data_transform=dt, key=1, dtype=dtype,
                   **FLOWS[name])
        flow.params = _perturb(flow.params, 2, jnp.asarray)
    else:
        dt = ttransforms.FlowTransform(parameters=NAMES, prior_bounds=BOUNDS,
                                       bounded_transform="logit",
                                       dtype=dtype, device="cpu")
        dt.fit(torch.as_tensor(x))
        cls = TFlowMatching if name == "cnf" else TFlow
        flow = cls(dims=D, data_transform=dt, seed=1, dtype=dtype,
                   device="cpu", **FLOWS[name])
        flow.params = _perturb(flow.params, 2, torch.as_tensor)
    return flow


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("writer", WRITERS)
@pytest.mark.parametrize("name", list(FLOWS))
def test_flows_cross_both_ways(tmp_path, name, writer, dtype):
    """A flow written by one package and loaded by the other gives the
    writer's ``log_prob``: parameters by the JAX leaf order, the config and
    the fitted data transform."""
    flow = _flow(writer, name, dtype)
    path = tmp_path / "flow.h5"
    with h5py.File(path, "w") as f:
        flow.save(f)
    with h5py.File(path, "r") as f:
        got = ((TFlowMatching if name == "cnf" else TFlow).load(
            f, device="cpu") if writer == "jax" else
            (JFlowMatching if name == "cnf" else JFlow).load(f))
    x = _x(64, seed=7).astype(dtype)
    want = np.asarray(flow.log_prob(jnp.asarray(x) if writer == "jax"
                                    else torch.as_tensor(x)))
    have = np.asarray(got.log_prob(torch.as_tensor(x) if writer == "jax"
                                   else jnp.asarray(x)))
    assert np.isfinite(want).all()
    np.testing.assert_allclose(have, want, **(F64 if dtype == "float64"
                                               else F32))
    assert _plain(got.config_dict()) == _plain(flow.config_dict())


def _plain(config):
    """A config with its sequences as lists of Python numbers."""
    if isinstance(config, dict):
        return {k: _plain(v) for k, v in config.items()}
    if isinstance(config, (tuple, list, np.ndarray)):
        return [_plain(v) for v in np.asarray(config).tolist()]
    return config
