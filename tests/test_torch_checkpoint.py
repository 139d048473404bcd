"""Checkpoint and resume in ``aspire_tpu_torch`` on the CPU: the port's
counterparts of ``tests/test_checkpointing.py`` (the three resume modes,
mid-run and completed checkpoints, flow preconditioning, the recorded
sampler, chain checkpoints, PT resumed bit for bit, crash recovery), and
the port's own promises: both ladders write the same checkpoint states,
bit for bit, at every rung; checkpoints change nothing of a run; a
checkpoint the JAX package wrote resumes in the port through the
restricted unpickler, which refuses any other JAX package or JAX global.
"""

import math
import pickle

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aspire_tpu import Aspire as JAspire
from aspire_tpu.checkpointing import RunFile as JRunFile
from aspire_tpu_torch import Aspire, Samples
from aspire_tpu_torch.checkpointing import RunFile
from aspire_tpu_torch.io import load_pickle
from aspire_tpu_torch.samplers.base import (
    Sampler,
    restore_generator,
    seed_from_jax_key,
)
from aspire_tpu_torch.samplers.mcmc import ParallelTemperedSampler
from aspire_tpu_torch.samplers.smc import SMCSampler

torch.set_num_threads(1)

DIMS = 2
TRUE_LOG_Z = -DIMS * math.log(20)
FLOW = dict(n_hidden=(16, 16), n_layers=2)
FIT = dict(n_epochs=8, batch_size=256)
HISTORY = ("beta", "ess", "ess_target", "eff_target", "log_norm_ratio",
           "log_norm_ratio_var", "mcmc_acceptance", "mcmc_autocorr",
           "lineage_fraction", "mutation_route", "nonfinite_target")


def log_likelihood(samples):
    return torch.sum(-0.5 * (samples.x - 1.0) ** 2
                     - 0.5 * math.log(2 * math.pi), dim=-1)


def log_prior(samples):
    x = samples.x
    inside = torch.all((x >= -10) & (x <= 10), dim=-1)
    return torch.where(inside, -DIMS * math.log(20.0),
                       torch.full_like(x[:, 0], -math.inf))


def make_aspire(**kwargs):
    return Aspire(log_likelihood=log_likelihood, log_prior=log_prior,
                  dims=DIMS, parameters=[f"x_{i}" for i in range(DIMS)],
                  prior_bounds={f"x_{i}": [-10, 10] for i in range(DIMS)},
                  seed=0, device="cpu", **FLOW, **kwargs)


@pytest.fixture(scope="module")
def initial_samples():
    rng = np.random.default_rng(3)
    return Samples(rng.normal(1.0, 1.1, size=(1000, DIMS)))


@pytest.fixture(scope="module")
def fitted(initial_samples):
    asp = make_aspire()
    asp.fit(initial_samples, **FIT)
    return asp


@pytest.fixture(scope="module")
def checkpoint_file(tmp_path_factory, initial_samples):
    """A complete checkpointed SMC run's file (``auto_checkpoint``)."""
    path = tmp_path_factory.mktemp("ckpt") / "ckpt.h5"
    asp = make_aspire()
    with asp.auto_checkpoint(path, every=1):
        asp.fit(initial_samples, **FIT)
        asp.sample_posterior(n_samples=200, sampler="smc",
                             n_final_samples=400,
                             sampler_kwargs={"n_steps": 5})
    return path


# -- the three resume modes ---------------------------------------------------


def test_resume_from_file(checkpoint_file):
    asp = Aspire.resume_from_file(str(checkpoint_file),
                                  log_likelihood=log_likelihood,
                                  log_prior=log_prior, device="cpu")
    assert asp.flow is not None and asp.flow.device.type == "cpu"
    samples = asp.sample_posterior(n_final_samples=400)
    assert len(samples) == 400
    assert float(samples.log_evidence) == pytest.approx(TRUE_LOG_Z, abs=0.7)
    assert asp.n_likelihood_evaluations > 0


def test_manual_resume(checkpoint_file, fitted):
    sampler = fitted.init_sampler("smc")
    samples = sampler.sample(200, resume_from=str(checkpoint_file),
                             n_final_samples=300)
    assert len(samples) == 300


def test_auto_checkpoint_resume_same_instance(checkpoint_file,
                                              initial_samples):
    asp = make_aspire()
    with asp.auto_checkpoint(checkpoint_file, every=1, resume=True):
        history = asp.fit(initial_samples, **FIT)
        assert history.training_loss == []  # the checkpointed flow
        samples = asp.sample_posterior(n_final_samples=400)
    assert len(samples) == 400
    assert asp._checkpoints is None and asp._resume is None
    assert not asp._skip_fit


def test_fit_skip_proven_by_raising_stub(checkpoint_file, initial_samples):
    asp = make_aspire()
    with asp.auto_checkpoint(checkpoint_file, every=1, resume=True):
        def boom(*a, **k):
            raise AssertionError("flow.fit should not be called")

        asp.flow.fit = boom
        assert asp.fit(initial_samples, **FIT).training_loss == []


def test_mid_run_resume(tmp_path, fitted):
    """Interrupted after two temperatures; a fresh sampler finishes it with
    the checkpoint's history as its prefix."""
    path = tmp_path / "mid.h5"
    sampler = fitted.init_sampler("smc")
    sampler.sample(200, max_n_steps=2, sampler_kwargs={"n_steps": 5},
                   checkpoint_every=1, checkpoint_file_path=str(path))
    first = sampler.history.beta
    assert len(first) <= 2
    sampler2 = fitted.init_sampler("smc")
    samples = sampler2.sample(200, resume_from=str(path),
                              sampler_kwargs={"n_steps": 5})
    assert sampler2.history.beta[:len(first)] == first
    assert sampler2.history.beta[-1] == 1.0
    assert float(samples.log_evidence) == pytest.approx(TRUE_LOG_Z, abs=0.7)


def test_completed_checkpoint_skips_loop(checkpoint_file, fitted):
    sampler = fitted.init_sampler("smc")
    samples = sampler.sample(200, resume_from=str(checkpoint_file),
                             n_final_samples=250)
    assert len(samples) == 250
    with h5py.File(checkpoint_file, "r") as f:
        n_rungs = len(load_pickle(bytes(np.asarray(
            f["checkpoint/state"][()]).tobytes()))["history"].beta)
    assert len(sampler.history.beta) == n_rungs


def test_resume_with_flow_preconditioning(tmp_path, fitted):
    """The fitted transport map rides in the checkpoint: the resumed
    sampler continues with the same map."""
    path = tmp_path / "flow_precond.h5"
    kw = dict(preconditioning="flow",
              preconditioning_kwargs={"fit_kwargs": {"n_epochs": 3}})
    sampler = fitted.init_sampler("smc", **kw)
    sampler.sample(128, max_n_steps=2, sampler_kwargs={"n_steps": 4},
                   checkpoint_every=1, checkpoint_file_path=str(path))
    fitted_map = sampler.preconditioning_transform
    assert fitted_map._params is not None
    fresh = fitted.init_sampler("smc", **kw)
    assert fresh.preconditioning_transform._params is None
    # The checkpoint holds host data only.
    with h5py.File(path, "r") as f:
        state = load_pickle(bytes(np.asarray(
            f["checkpoint/state"][()]).tobytes()))
    payload = state["preconditioning_state"]
    assert payload["class"] == "FlowPreconditioningTransform"
    samples = fresh.sample(128, resume_from=str(path),
                           sampler_kwargs={"n_steps": 4})
    restored = fresh.preconditioning_transform
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(16, DIMS)))
    for a, b in zip(fitted_map.forward(x), restored.forward(x)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fresh.history.beta[-1] == 1.0
    assert np.isfinite(float(samples.log_evidence))


def test_resume_from_file_resumes_recorded_sampler(checkpoint_file):
    asp = Aspire.resume_from_file(str(checkpoint_file),
                                  log_likelihood=log_likelihood,
                                  log_prior=log_prior, device="cpu")
    assert asp._resume is not None and asp._resume.sampler_type == "smc"
    samples = asp.sample_posterior(n_final_samples=250)
    assert isinstance(asp.sampler, SMCSampler)
    assert len(samples) == 250


def test_config_files_cross_both_ways(tmp_path, fitted):
    """The Aspire config one package writes rebuilds the other's."""
    jasp = JAspire(log_likelihood=lambda s: s.x[:, 0],
                   log_prior=lambda s: s.x[:, 0], dims=DIMS,
                   prior_bounds={f"x_{i}": [-10, 10] for i in range(DIMS)},
                   flow_backend="nsf", n_layers=2, n_hidden=(16, 16))
    for writer, reader, cls in ((jasp, RunFile, Aspire),
                                (fitted, JRunFile, JAspire)):
        path = tmp_path / f"{type(writer).__module__}.h5"
        with h5py.File(path, "w") as f:
            writer.save_config(f)
        kwargs = reader(str(path)).constructor_kwargs(cls)
        rebuilt = cls(log_likelihood=log_likelihood, log_prior=log_prior,
                      **kwargs)
        for name in ("dims", "parameters", "flow_backend", "eps",
                     "bounded_transform"):
            assert getattr(rebuilt, name) == getattr(writer, name), name
        assert {k: list(v) for k, v in rebuilt.prior_bounds.items()} == {
            k: list(v) for k, v in writer.prior_bounds.items()}
        assert list(rebuilt.flow_kwargs["n_hidden"]) == [16, 16]


# -- chain and PT state checkpoints ----------------------------------------------


def test_mcmc_chain_checkpoint(tmp_path, fitted):
    path = tmp_path / "mcmc.h5"
    fitted.sample_posterior(n_samples=64, sampler="minipcn", n_steps=20,
                            checkpoint_path=str(path))
    with h5py.File(path, "r") as f:
        ds = f["checkpoint/mcmc_chain"]
        assert ds.shape == (20, 64, DIMS)
        assert int(ds.attrs["iteration"]) == 20
        assert "aspire_config" in f and "flow" in f and "sampler_config" in f
    chain, it = fitted.sampler.load_chain_checkpoint(str(path))
    assert chain.shape == (20, 64, DIMS) and it == 20

    pt_path = tmp_path / "pt.h5"
    fitted.sample_posterior(n_samples=16, sampler="ptmcmc", n_steps=12,
                            n_temperatures=4, swap_every=4,
                            checkpoint_path=str(pt_path))
    with h5py.File(pt_path, "r") as f:
        ds = f["checkpoint/mcmc_chain"]
        assert ds.shape == (4, 3, 16, DIMS)
        betas = np.asarray(ds.attrs["betas"])
        assert betas.shape == (4,) and betas[0] == 1.0

    off_path = tmp_path / "off.h5"
    fitted.sample_posterior(n_samples=32, sampler="emcee", n_steps=10,
                            checkpoint_path=str(off_path), checkpoint_every=0)
    with h5py.File(off_path, "r") as f:
        assert "checkpoint/mcmc_chain" not in f


class _Killed(RuntimeError):
    pass


def _crash_after(sampler, rounds: int):
    real = sampler.save_pt_state

    def crashing_save(file_path, **kw):
        real(file_path, **kw)
        if kw["rounds_done"] == rounds:
            raise _Killed()

    sampler.save_pt_state = crashing_save
    return real


PT = dict(n_steps=24, n_temperatures=4, swap_every=4)


def test_pt_midrun_checkpoint_resume(tmp_path, fitted):
    """A run killed after round 2's state and resumed from the file is the
    uninterrupted run, bit for bit (the generator's state is saved at the
    round); a completed state resumes with no rounds run again."""
    ref = fitted.init_sampler("ptmcmc", preconditioning="none").sample(16,
                                                                      **PT)
    path = tmp_path / "pt_state.h5"
    full = fitted.init_sampler("ptmcmc", preconditioning="none").sample(
        16, **PT, checkpoint_file_path=str(path), state_checkpoint_every=2)
    np.testing.assert_array_equal(full.x.numpy(), ref.x.numpy())
    with h5py.File(path, "r") as f:
        assert int(f["checkpoint/pt_state"].attrs["rounds_done"]) == 6

    crash_path = tmp_path / "pt_crash.h5"
    s3 = fitted.init_sampler("ptmcmc", preconditioning="none")
    real = _crash_after(s3, 2)
    with pytest.raises(_Killed):
        s3.sample(16, **PT, checkpoint_file_path=str(crash_path),
                  state_checkpoint_every=2)
    s3.save_pt_state = real
    with h5py.File(crash_path, "r") as f:
        assert int(f["checkpoint/pt_state"].attrs["rounds_done"]) == 2
    resumed = s3.sample(16, **PT, resume_from=str(crash_path))
    for name in ("x", "log_likelihood", "log_prior"):
        np.testing.assert_array_equal(getattr(resumed, name).numpy(),
                                      getattr(ref, name).numpy())
    np.testing.assert_array_equal(resumed.swap_acceptance,
                                  ref.swap_acceptance)

    s4 = fitted.init_sampler("ptmcmc", preconditioning="none")
    full2 = s4.sample(16, **PT, checkpoint_file_path=str(path),
                      state_checkpoint_every=2)
    before = s4.n_likelihood_evaluations
    again = s4.sample(16, **PT, resume_from=str(path))
    np.testing.assert_array_equal(again.x.numpy(), full2.x.numpy())
    assert s4.n_likelihood_evaluations == before
    with pytest.raises(ValueError, match="disagrees"):
        s4.sample(16, n_steps=32, n_temperatures=4, swap_every=4,
                  resume_from=str(path))


def test_pt_facade_resume_from_file(tmp_path, fitted):
    path = tmp_path / "pt_run.h5"
    asp = make_aspire()
    asp.flow = fitted.flow
    post = asp.sample_posterior(sampler="ptmcmc", n_samples=16,
                                preconditioning="none",
                                state_checkpoint_every=2,
                                checkpoint_path=str(path), **PT)
    asp2 = Aspire.resume_from_file(str(path), log_likelihood=log_likelihood,
                                   log_prior=log_prior, device="cpu")
    assert asp2._resume.sampler_type == "ptmcmc"
    post2 = asp2.sample_posterior()
    np.testing.assert_array_equal(post2.x.numpy(), post.x.numpy())
    assert asp2.sampler.n_likelihood_evaluations == 0


def test_pt_facade_crash_recovery(tmp_path, fitted):
    """Killed before any post-sample record exists: ``resume_from_file``
    and a bare ``sample_posterior()`` continue from the PT state's own
    attributes, paying only for the remaining rounds."""
    path = tmp_path / "pt_crash_facade.h5"
    asp = make_aspire()
    asp.flow = fitted.flow
    real = ParallelTemperedSampler.save_pt_state

    def crashing_save(self, file_path, **kw):
        real(self, file_path, **kw)
        if kw["rounds_done"] == 2:
            raise _Killed()

    ParallelTemperedSampler.save_pt_state = crashing_save
    try:
        with pytest.raises(_Killed):
            asp.sample_posterior(sampler="ptmcmc", n_samples=16,
                                 preconditioning="none",
                                 state_checkpoint_every=2,
                                 checkpoint_path=str(path), **PT)
    finally:
        ParallelTemperedSampler.save_pt_state = real
    with h5py.File(path, "r") as f:
        assert "sampler_config" not in f
        assert "aspire_config" in f and "flow" in f
    asp2 = Aspire.resume_from_file(str(path), log_likelihood=log_likelihood,
                                   log_prior=log_prior, device="cpu")
    assert asp2._resume.sampler_type == "ptmcmc"
    assert asp2._resume.n_samples == 16
    post = asp2.sample_posterior()
    assert tuple(post.x.shape) == (4 * 6 * 16, DIMS)
    assert asp2.sampler.n_likelihood_evaluations == 4 * 4 * 4 * 16


# -- both ladders, checkpoints on and off ---------------------------------------------


def _run(asp, ladder, states=None, **kw):
    post, hist = asp.sample_posterior(
        sampler="smc", n_samples=kw.pop("n", 512), store_sample_history=False,
        return_history=True, device_ladder=ladder,
        checkpoint_callback=None if states is None else states.append,
        sampler_kwargs=dict(n_steps=4, **kw.pop("chain", {})), **kw)
    return post, hist


def _assert_states_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        if key == "config":
            continue
        va, vb = a[key], b[key]
        if key == "samples":
            assert va.beta == vb.beta
            for f in ("x", "log_likelihood", "log_prior", "log_q"):
                np.testing.assert_array_equal(getattr(va, f), getattr(vb, f))
        elif key == "history":
            for name in HISTORY:
                assert getattr(va, name) == getattr(vb, name), name
        elif isinstance(va, np.ndarray):
            np.testing.assert_array_equal(va, vb)
        else:
            assert va == vb, key


@pytest.fixture(scope="module")
def nsf():
    """A small nsf-tpu-shaped flow on a 4-d Gaussian mixture."""
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=4)
    init = Samples(p.draw_initial_samples(np.random.default_rng(42), 1000))
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=4, seed=1, device="cpu", flow_backend="nsf",
                 architecture="nsf-tpu", n_hidden=(16, 16), n_layers=2)
    asp.fit(init, n_epochs=3, batch_size=256, learning_rate=3e-3)
    return asp


@pytest.mark.parametrize("chain", [{}, {"fused_chain": False}],
                         ids=["fused_kernel", "split"])
def test_both_ladders_write_the_same_states_at_every_rung(nsf, chain):
    """The device ladder's checkpoint between rungs is the host ladder's at
    the same temperature, bit for bit (population, history, generator
    state, evaluations, lineage fraction), and a run with checkpoints is
    the run without them."""
    off, off_hist = _run(nsf, True, chain=chain)
    host_states, dev_states = [], []
    host, _ = _run(nsf, False, host_states, chain=chain)
    dev, dev_hist = _run(nsf, True, dev_states, chain=chain)
    n = len(off_hist.beta)
    assert [s["iteration"] for s in dev_states] == [*range(1, n + 1), n]
    assert len(host_states) == len(dev_states)
    for a, b in zip(host_states, dev_states):
        _assert_states_equal(a, b)
    assert torch.equal(dev.x, off.x) and torch.equal(host.x, off.x)
    for name in HISTORY:
        assert getattr(dev_hist, name) == getattr(off_hist, name), name
    for state in dev_states:
        pickle.loads(Sampler.serialize_checkpoint_state(state))
        assert not any(isinstance(v, torch.Tensor) for v in state.values())


def test_both_ladders_resume_one_checkpoint_alike(nsf):
    """The middle state's bytes resumed on each ladder: one population, the
    checkpoint's history as the prefix, beta 1; the last state skips the
    loop; ``max_n_steps`` counts the checkpoint's iterations."""
    states = []
    _run(nsf, True, states)
    mid = Sampler.serialize_checkpoint_state(states[len(states) // 2 - 1])
    prefix = load_pickle(mid)["history"]
    out = {}
    for ladder in (True, False):
        post, hist = _run(nsf, ladder, resume_from=mid)
        out[ladder] = post
        assert hist.beta[:len(prefix.beta)] == prefix.beta
        assert hist.beta[-1] == 1.0
    assert torch.equal(out[True].x, out[False].x)
    last = Sampler.serialize_checkpoint_state(states[-1])
    post, hist = _run(nsf, True, resume_from=last)
    assert len(hist.beta) == len(states[-1]["history"].beta)
    assert nsf.sampler.ladder is None
    post, hist = _run(nsf, True, resume_from=mid,
                      max_n_steps=len(prefix.beta) + 1)
    assert len(hist.beta) == len(prefix.beta) + 1


# -- the JAX package's checkpoints ------------------------------------------------------


def _jax_checkpoint(path, state: dict):
    """The JAX package writes ``state`` (a port run's checkpoint) as its own
    SMC checkpoint: its ``SMCSamples`` (with a snapshot in the history),
    its ``SMCHistory`` and PRNG key, through its ``build_checkpoint_state``
    and ``save_checkpoint_to_hdf``. (A JAX run of its own would cost its
    compiles, seconds, to write the same layout.)"""
    from aspire_tpu.history import SMCHistory as JHistory
    from aspire_tpu.samplers.smc import PCNSMC as JPCNSMC
    from aspire_tpu.samples import SMCSamples as JSMCSamples

    s = state["samples"]

    def jsamples(x=s.x):
        return JSMCSamples(x=x, log_likelihood=s.log_likelihood,
                           log_prior=s.log_prior, log_q=s.log_q, beta=s.beta,
                           parameters=s.parameters)

    jsampler = JPCNSMC(log_likelihood=log_likelihood, log_prior=log_prior,
                       dims=DIMS, prior_flow=None, rng=7)
    h = state["history"]
    jsampler.history = JHistory(**{
        f: list(getattr(h, f)) for f in JHistory.__dataclass_fields__
        if f != "sample_history"})
    jsampler.history.sample_history = [jsamples().to_numpy()]
    jsampler.sampler_kwargs = dict(state["sampler_kwargs"])
    jsampler._lineage_fraction = state["lineage_fraction"]
    jstate = jsampler.build_checkpoint_state(
        jsamples(), state["iteration"], meta={"beta": s.beta})
    jsampler.save_checkpoint_to_hdf(jstate, str(path))
    return jstate


def test_jax_checkpoint_resumes_in_the_port(tmp_path, fitted):
    """A checkpoint file the JAX package wrote: its arrays, its pickled
    state (``SMCHistory`` and ``SMCSamples`` read as the port's), its key
    seeding the port's generator by ``seed_from_jax_key``; the run goes on
    from it."""
    states = []
    fitted.init_sampler("smc").sample(
        128, max_n_steps=2, sampler_kwargs={"n_steps": 3},
        device_ladder=False, checkpoint_callback=states.append)
    path = tmp_path / "jax.h5"
    jstate = _jax_checkpoint(path, states[0])
    with h5py.File(path, "r") as f:
        blob = bytes(np.asarray(f["checkpoint/state"][()]).tobytes())
    import pickletools

    globals_ = {arg for op, arg, _ in pickletools.genops(blob)
                if op.name in ("GLOBAL", "STACK_GLOBAL")}
    strings = {arg for op, arg, _ in pickletools.genops(blob)
               if isinstance(arg, str)}
    assert {"aspire_tpu.history", "SMCHistory", "aspire_tpu.samples",
            "SMCSamples"} <= strings | globals_
    state = Sampler.load_checkpoint_from_file(str(path))
    assert state["history"].beta == states[0]["history"].beta
    assert state["history"].mutation_route == []
    snap = state["history"].sample_history[0]
    assert type(snap).__module__ == "aspire_tpu_torch.samples"
    np.testing.assert_array_equal(snap.x, states[0]["samples"].x)
    np.testing.assert_array_equal(state["samples"].x,
                                  states[0]["samples"].x)
    sampler = fitted.init_sampler("smc")
    restore_generator(sampler.generator, state)
    gen = torch.Generator()
    gen.manual_seed(seed_from_jax_key(jstate["key"]))
    assert torch.equal(sampler.generator.get_state(), gen.get_state())
    samples = sampler.sample(128, resume_from=str(path),
                             sampler_kwargs={"n_steps": 3})
    assert sampler.history.beta[:1] == states[0]["history"].beta
    assert sampler.history.beta[-1] == 1.0
    assert float(samples.log_evidence) == pytest.approx(TRUE_LOG_Z, abs=0.7)


def test_foreign_globals_are_refused():
    """Only the mapped classes of the JAX package pass; any other global of
    the JAX package or of JAX is refused with a message."""
    import aspire_tpu.samples as jsamples

    blob = pickle.dumps({"samples": jsamples.Samples(np.zeros((2, DIMS)))})
    with pytest.raises(pickle.UnpicklingError, match="aspire_tpu.samples"):
        load_pickle(blob)
    with pytest.raises(pickle.UnpicklingError, match="jax"):
        load_pickle(pickle.dumps(jnp.zeros(3)))
    assert load_pickle(pickle.dumps({"a": np.arange(3)}))["a"].tolist() == [
        0, 1, 2]


def test_a_generator_state_of_another_device_type_raises():
    gen = torch.Generator()
    state = {"generator_state": gen.get_state().numpy(),
             "generator_device": "cuda"}
    with pytest.raises(ValueError, match="cuda"):
        restore_generator(gen, state)
