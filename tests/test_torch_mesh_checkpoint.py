"""Shard-local checkpoints, resume and sample history on a mesh of gloo
ranks (float64, the CPU), and the four shard names of ``io`` against the
JAX package's.

A run on two ranks writes a checkpoint a rung on each ladder, every rank
its own rows (the main file on rank 0, ``.proc1`` on rank 1), with the
sample history's rows as shard blocks. Reassembled, each rung's checkpoint
is the one-process run's (population, history, its sample history,
generator state, iteration). From rung 3's files the run resumes on two
ranks, on one process and on four ranks, each giving the bits of the
one-process run resumed from its own rung 3 (a resumed run re-adapts its
step sizes from their defaults, as the JAX package's does, so no resumed
run repeats the uninterrupted one).

Each rank count (2, then 4, which resumes from the 2-rank files) is one job
of ``spawn`` processes for the module; each test reads the saved results.
The rank function sits here at the top level; JAX is imported by the tests
only.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from aspire_tpu_torch.parallel import mesh as M

pytest.importorskip("h5py")

N = 128
STEPS = 4
TARGET_EFF = 0.9
RESUME_RUNG = 3
FLOW = dict(flow_backend="nsf", n_hidden=(8, 8), n_layers=2)
LADDERS = {"host": False, "device": True}


def fitted_aspire():
    """The 2-d mixture's Aspire on the CPU in float64, a small nsf fitted
    at seed 1: each rank fits its own, the same bits."""
    from aspire_tpu_torch import Aspire, Samples
    from aspire_tpu_torch.models import GaussianMixtureProblem

    p = GaussianMixtureProblem(dims=2)
    asp = Aspire(log_likelihood=p.log_likelihood, log_prior=p.log_prior,
                 dims=2, seed=1, device="cpu", dtype="float64", **FLOW)
    asp.fit(Samples(p.draw_initial_samples(np.random.default_rng(0), 512)),
            n_epochs=2, batch_size=128, learning_rate=3e-3)
    return asp


def summary(post, sampler) -> dict:
    return {"beta": list(sampler.history.beta), "log_z": post.log_evidence,
            "x": post.x.clone(), "log_l": post.log_likelihood.clone(),
            "generator": sampler.generator.get_state().clone(),
            "evals": sampler.n_likelihood_evaluations}


def checkpointed_run(asp, ladder: str, folder: str, mesh=None) -> dict:
    """The mixture's tpCN run on ``ladder`` with a checkpoint file a rung
    (``folder/ck_{ladder}_{iteration}.h5``) and the sample history."""
    sampler = asp.init_sampler("smc", mesh=mesh)

    def callback(state):
        sampler.save_checkpoint_to_hdf(
            state, f"{folder}/ck_{ladder}_{state['iteration']}.h5")

    post = sampler.sample(N, device_ladder=LADDERS[ladder],
                          target_efficiency=TARGET_EFF,
                          store_sample_history=True,
                          checkpoint_callback=callback,
                          sampler_kwargs=dict(n_steps=STEPS))
    return summary(post, sampler)


def resumed_run(asp, ladder: str, path: str, mesh=None) -> dict:
    sampler = asp.init_sampler("smc", mesh=mesh)
    post = sampler.sample(N, device_ladder=LADDERS[ladder],
                          target_efficiency=TARGET_EFF, resume_from=path,
                          sampler_kwargs=dict(n_steps=STEPS))
    return summary(post, sampler)


def _rank_job(rank: int, size: int, folder: str, source: str) -> None:
    """One rank: on two ranks each ladder's checkpointed run (its files in
    ``folder``) and its resume from rung RESUME_RUNG; on four ranks the
    resume from the two-rank files in ``source``. Saved to
    ``folder/out{rank}.pt``."""
    torch.set_num_threads(1)
    M.initialize_distributed(num_processes=size, process_id=rank,
                             backend="gloo",
                             init_method=f"file://{folder}/rdv")
    mesh = M.make_mesh(device="cpu")
    asp = fitted_aspire()
    out = {}
    for ladder in LADDERS:
        if size == 2:
            out[ladder] = checkpointed_run(asp, ladder, folder, mesh)
        out[ladder, "resumed"] = resumed_run(
            asp, ladder, f"{source}/ck_{ladder}_{RESUME_RUNG}.h5", mesh)
    torch.save(out, f"{folder}/out{rank}.pt")


def _load(path):
    from aspire_tpu_torch.samplers.base import Sampler

    return Sampler.load_checkpoint_from_file(str(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two- and four-rank jobs, and in this process the same runs with
    no mesh plus the resume from the two-rank files."""
    two = tmp_path_factory.mktemp("mesh_ck2")
    four = tmp_path_factory.mktemp("mesh_ck4")
    one = tmp_path_factory.mktemp("mesh_ck1")
    M.spawn_ranks(_rank_job, 2, (2, str(two), str(two)), timeout=600)
    M.spawn_ranks(_rank_job, 4, (4, str(four), str(two)), timeout=600)
    asp = fitted_aspire()
    single = {}
    for ladder in LADDERS:
        single[ladder] = checkpointed_run(asp, ladder, str(one))
        single[ladder, "resumed"] = resumed_run(
            asp, ladder, str(one / f"ck_{ladder}_{RESUME_RUNG}.h5"))
        single[ladder, "resumed_from_two"] = resumed_run(
            asp, ladder, str(two / f"ck_{ladder}_{RESUME_RUNG}.h5"))
    return {"folders": {1: one, 2: two, 4: four}, "one": single, 2: [
        torch.load(two / f"out{r}.pt", weights_only=False)
        for r in range(2)], 4: [torch.load(four / f"out{r}.pt",
                                           weights_only=False)
                                for r in range(4)]}


def _same(got: dict, want: dict) -> None:
    assert got["beta"] == want["beta"]
    assert got["log_z"] == want["log_z"]
    assert torch.equal(got["x"], want["x"])
    assert torch.equal(got["log_l"], want["log_l"])
    assert torch.equal(got["generator"], want["generator"])
    assert got["evals"] == want["evals"]


@pytest.mark.parametrize("ladder", LADDERS)
def test_checkpointed_run_on_two_ranks_equals_one_process(runs, ladder):
    """The checkpointed run with its sample history on two ranks: on every
    rank the one-process run's bits; more than RESUME_RUNG rungs."""
    for r in runs[2]:
        _same(r[ladder], runs["one"][ladder])
    assert len(runs["one"][ladder]["beta"]) > RESUME_RUNG


@pytest.mark.parametrize("ladder", LADDERS)
def test_every_rung_checkpoint_reassembles_to_one_process(runs, ladder):
    """Each rung's two-rank checkpoint: a main file and a ``.proc1`` file;
    loaded, its population, iteration, generator state, history and sample
    history (each rung's population reassembled from the two files) are
    the one-process checkpoint's."""
    two, one = runs["folders"][2], runs["folders"][1]
    rungs = len(runs["one"][ladder]["beta"])
    for it in range(1, rungs + 1):
        path = two / f"ck_{ladder}_{it}.h5"
        assert path.exists() and (two / f"{path.name}.proc1").exists()
        got, want = _load(path), _load(one / f"ck_{ladder}_{it}.h5")
        assert got["iteration"] == want["iteration"] == it
        np.testing.assert_array_equal(got["generator_state"],
                                      want["generator_state"])
        for name in ("x", "log_likelihood", "log_prior", "log_q"):
            np.testing.assert_array_equal(getattr(got["samples"], name),
                                          getattr(want["samples"], name))
        assert got["history"].beta == want["history"].beta
        snaps, wants = (s["history"].sample_history for s in (got, want))
        assert len(snaps) == len(wants) == it + 1
        for a, b in zip(snaps, wants):
            assert a.beta == b.beta
            np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
            np.testing.assert_array_equal(np.asarray(a.log_q),
                                          np.asarray(b.log_q))


@pytest.mark.parametrize("ladder", LADDERS)
@pytest.mark.parametrize("where", ["two ranks", "one process",
                                   "four ranks"])
def test_resume_from_two_rank_files(runs, ladder, where):
    """Resumed from the two-rank files of rung RESUME_RUNG on two ranks, on
    one process and on four ranks: every rank gives the bits of the
    one-process run resumed from its own rung RESUME_RUNG."""
    want = runs["one"][ladder, "resumed"]
    got = {"two ranks": [r[ladder, "resumed"] for r in runs[2]],
           "one process": [runs["one"][ladder, "resumed_from_two"]],
           "four ranks": [r[ladder, "resumed"] for r in runs[4]]}[where]
    for r in got:
        _same(r, want)


def test_a_lost_proc_file_raises(runs, tmp_path):
    """Without its ``.proc1`` file a two-rank checkpoint does not load: the
    rows rank 1 held are missing and the loader says so."""
    src = runs["folders"][2] / "ck_host_1.h5"
    shutil.copy(src, tmp_path / "lost.h5")
    with pytest.raises(ValueError, match="unfilled"):
        _load(tmp_path / "lost.h5")
    shutil.copy(f"{src}.proc1", tmp_path / "lost.h5.proc1")
    assert _load(tmp_path / "lost.h5")["samples"].x.shape == (N, 2)


# -- the four io names against the JAX package's -------------------------


@pytest.fixture
def ranked(monkeypatch):
    """Set both packages' process index (the port's from torch.distributed,
    the JAX package's from JAX) to a rank, as on a mesh of processes."""
    import jax

    def set_rank(rank: int) -> None:
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(M, "process_index", lambda: rank)

    return set_rank


@pytest.mark.parametrize("rank", [0, 1, 3])
def test_process_paths_match_jax(ranked, rank, tmp_path):
    """``process_checkpoint_path`` and ``checkpoint_shard_files`` give the
    JAX package's names on each rank; ``checkpoint_barrier`` is a no-op in
    one process in both."""
    from aspire_tpu import io as J

    from aspire_tpu_torch import io as T

    ranked(rank)
    path = str(tmp_path / "run.h5")
    assert T.process_checkpoint_path(path) == J.process_checkpoint_path(path)
    for r in (0, 1, 3):
        (tmp_path / ("run.h5" if r == 0 else f"run.h5.proc{r}")).touch()
    assert T.checkpoint_shard_files(path) == J.checkpoint_shard_files(path)
    assert T.checkpoint_barrier() is None and J.checkpoint_barrier() is None


def _blocks():
    rng = np.random.default_rng(4)
    return rng.normal(size=(10, 3)), [(0, [0, 6], [3, 3]), (1, [3, 8],
                                                             [3, 2])]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shard_blocks_read_both_ways(ranked, writer, tmp_path):
    """Two processes' row blocks of a (10, 3) array (rank 0 rows 0-2 and
    6-8, rank 1 rows 3-5 and 8-9, in their own files) written by either
    package's ``save_shard_blocks``: the same datasets, names and
    attributes, and both packages' ``load_sharded_array`` reassemble the
    array from the two files."""
    import h5py

    from aspire_tpu import io as J

    from aspire_tpu_torch import io as T

    x, plan = _blocks()
    write = {"port": T.save_shard_blocks, "jax": J.save_shard_blocks}
    for mod, folder in (("port", tmp_path / "p"), ("jax", tmp_path / "j")):
        folder.mkdir()
        for rank, starts, sizes in plan:
            ranked(rank)
            rows = np.concatenate([x[s:s + k] for s, k in zip(starts,
                                                               sizes)])
            with h5py.File(J.process_checkpoint_path(str(folder / "a.h5")),
                           "a") as f:
                write[mod](f, "checkpoint/arrays/x", rows, x.shape, starts,
                           sizes)
    ranked(0)

    def layout(folder):
        out = {}
        for path in T.checkpoint_shard_files(str(folder / "a.h5")):
            with h5py.File(path, "r") as f:
                g = f["checkpoint/arrays/x"]
                out[path.rsplit("/", 1)[1]] = (
                    tuple(g.attrs["global_shape"]), g.attrs["dtype"],
                    {k: (tuple(ds.attrs["start"]), ds[()].tobytes())
                     for k, ds in g.items()})
        return out

    assert layout(tmp_path / "p") == layout(tmp_path / "j")
    folder = tmp_path / ("p" if writer == "port" else "j")
    files = [h5py.File(p, "r")
             for p in T.checkpoint_shard_files(str(folder / "a.h5"))]
    try:
        np.testing.assert_array_equal(
            T.load_sharded_array(files, "checkpoint/arrays/x"), x)
        np.testing.assert_array_equal(
            J.load_sharded_array(files, "checkpoint/arrays/x"), x)
    finally:
        for f in files:
            f.close()


def test_sharded_array_rank_block_and_offset(ranked, tmp_path):
    """``save_sharded_array`` with a rank's block and global offset writes
    the JAX package's dataset of that rank; ``load_sharded_array`` with a
    ``Sharding`` reads one rank's block of the reassembled array, and the
    whole without one; the JAX package reads the files."""
    import h5py

    from aspire_tpu import io as J

    from aspire_tpu_torch import io as T

    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    path = str(tmp_path / "s.h5")
    for rank in (0, 1):
        ranked(rank)
        with h5py.File(T.process_checkpoint_path(path), "a") as f:
            T.save_sharded_array(f, "a", x[4 * rank:4 * rank + 4],
                                 [4 * rank], 8)
            assert list(f["a"]) == [f"shard_p{rank}_{4 * rank}_0"]
    ranked(0)
    files = [h5py.File(p, "r") for p in T.checkpoint_shard_files(path)]
    try:
        np.testing.assert_array_equal(T.load_sharded_array(files, "a"), x)
        np.testing.assert_array_equal(J.load_sharded_array(files, "a"), x)
        for rank in (0, 1):
            mesh = M.ProcessMesh(group=None, size=2, rank=rank)
            np.testing.assert_array_equal(
                T.load_sharded_array(files, "a", M.particle_sharding(mesh)),
                x[4 * rank:4 * rank + 4])
    finally:
        for f in files:
            f.close()
