"""aspire_tpu_torch.parallel and the collective resamplers against the JAX
package (its 8-device virtual CPU mesh): the mesh helpers' blocks and
padding, and the ring and all-to-all movement steps, given the JAX
package's global index, on 2 and 4 gloo ranks, bit for bit against the
JAX package's ``ring_resample_matrix`` / ``alltoall_resample_matrix`` and
``data[idx]``; the all-to-all overflow taking the ring; the primitives'
counts that tell the schedules apart; the divisibility errors.

Each rank count is one job of ``spawn`` processes for the module (ranks
meet at a ``file://`` rendezvous in a temporary directory), which runs
every check and saves what it found; each test reads one result. The rank
function sits here at the top level; JAX is imported by the tests only.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from aspire_tpu_torch.parallel import mesh as M
from aspire_tpu_torch.ops import resampling as TR

METHODS = ("systematic", "multinomial", "stratified", "residual")
N, D = 512, 3
N_OUTS = (None, 64)
RANKS = (2, 4)
JAX_MESH = 8


def _inputs():
    rng = np.random.default_rng(7)
    lw = rng.normal(size=N).astype(np.float32)
    x = rng.normal(size=(N, D)).astype(np.float32)
    lw_deg = np.where(np.arange(N) == 3, 50.0, -50.0).astype(np.float32)
    return lw, x, lw_deg


def _rank_job(rank: int, size: int, folder: str) -> None:
    """One rank of a job: every check on this rank's block, its results
    saved to ``folder/out{rank}.pt``."""
    torch.set_num_threads(1)
    M.initialize_distributed(num_processes=size, process_id=rank,
                             backend="gloo",
                             init_method=f"file://{folder}/rdv")
    mesh = M.make_mesh(device="cpu")
    given = torch.load(f"{folder}/in.pt", weights_only=False)
    x = torch.as_tensor(given["x"])
    block = mesh.local_rows(x)
    out = {"mesh": (mesh.size, mesh.rank, mesh.backend, str(mesh.device))}
    for key, idx in given["idx"].items():
        idx = torch.as_tensor(idx)
        out[("ring",) + key] = TR.ring_move(idx, block, mesh)
        out[("alltoall",) + key] = TR.alltoall_move(idx, block, mesh)
    # All weight on one particle: the buckets overflow, the ring runs. (On
    # 2 and 4 ranks the default cap is the whole output block, which no
    # pair can pass: a cap of 16 rows, as on a larger mesh.)
    M.reset_collective_counts()
    rows, took_ring = TR.alltoall_move(torch.as_tensor(given["idx_deg"]),
                                       block, mesh, cap=16)
    out["overflow"] = (rows, took_ring, dict(M.collective_counts))
    # Each schedule's primitives, on the port's own index.
    lw = mesh.local_rows(torch.as_tensor(given["lw"]))
    for impl, fn in (("ring", TR.ring_resample_matrix),
                     ("alltoall", TR.alltoall_resample_matrix)):
        gen = torch.Generator().manual_seed(5)
        M.reset_collective_counts()
        out[("schedule", impl)] = (fn(gen, lw, block, mesh),
                                   dict(M.collective_counts))
    from aspire_tpu_torch.samples import SMCSamples

    pop = SMCSamples(x=block, beta=0.2, dtype=torch.float32)
    pop.log_likelihood = pop.log_prior = pop.log_q = lw
    for impl in ("auto", "ring", "alltoall"):
        M.reset_collective_counts()
        res = pop.resample(0.6, torch.Generator().manual_seed(5),
                           impl=impl, mesh=mesh)
        out[("samples", impl)] = (res.x, res.log_q,
                                  dict(M.collective_counts))
    for impl, fn in (("ring", TR.ring_resample_matrix),
                     ("alltoall", TR.alltoall_resample_matrix)):
        try:
            fn(torch.Generator(), lw, block, mesh, n_out=13)
            out[("error", impl)] = None
        except ValueError as err:
            out[("error", impl)] = str(err)
    out["gathered"] = M.all_gather_rows(block, mesh)
    out["reduced"] = (M.all_reduce(torch.tensor([rank + 1]), mesh),
                      M.all_reduce(torch.tensor([0.5 * rank]), mesh))
    torch.save(out, f"{folder}/out{rank}.pt")


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's index vectors and collective outputs on its mesh,
    for every method and ``n_out``; the degenerate weights' index."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from aspire_tpu.ops import resampling as JR
    from aspire_tpu.parallel.mesh import make_mesh

    lw, x, lw_deg = _inputs()
    mesh = make_mesh(JAX_MESH)
    sh = NamedSharding(mesh, P("data"))
    lw_s, x_s = jax.device_put(jnp.asarray(lw), sh), jax.device_put(
        jnp.asarray(x), sh)
    key = jax.random.key(11)
    out = {"idx": {}, "ring": {}, "alltoall": {}}
    for m in METHODS:
        for n_out in N_OUTS:
            k = (m, n_out)
            out["idx"][k] = np.asarray(
                JR.get_resampler(m)(key, jnp.asarray(lw), n_out or N))
            out["ring"][k] = np.asarray(JR.ring_resample_matrix(
                key, lw_s, x_s, mesh, method=m, n_out=n_out))
            out["alltoall"][k] = np.asarray(JR.alltoall_resample_matrix(
                key, lw_s, x_s, mesh, method=m, n_out=n_out))
    out["idx_deg"] = np.asarray(JR.get_resampler("systematic")(
        key, jnp.asarray(lw_deg), N))
    out["a2a_deg"] = np.asarray(JR.alltoall_resample_matrix(
        key, jax.device_put(jnp.asarray(lw_deg), sh), x_s, mesh))
    errors = {}
    for impl, fn in (("ring", JR.ring_resample_matrix),
                     ("alltoall", JR.alltoall_resample_matrix)):
        with pytest.raises(ValueError) as err:
            fn(key, lw_s, x_s, mesh, n_out=13)
        errors[impl] = str(err.value)
    out["errors"] = errors
    return out


@pytest.fixture(scope="module")
def jobs(jax_side, tmp_path_factory):
    """``{ranks: [each rank's results]}`` for 2 and 4 ranks."""
    lw, x, _ = _inputs()
    out = {}
    for size in RANKS:
        folder = tmp_path_factory.mktemp(f"mesh{size}")
        torch.save({"x": x, "lw": lw, "idx": jax_side["idx"],
                    "idx_deg": jax_side["idx_deg"]}, folder / "in.pt")
        M.spawn_ranks(_rank_job, size, (size, str(folder)), timeout=300)
        out[size] = [torch.load(folder / f"out{r}.pt", weights_only=False)
                     for r in range(size)]
    return out


def _joined(results, key):
    return torch.cat([r[key] if not isinstance(r[key], tuple)
                      else r[key][0] for r in results]).numpy()


# -- the mesh helpers (one process: a mesh's rank and size suffice) ------


def _fake_mesh(size: int, rank: int) -> M.ProcessMesh:
    return M.ProcessMesh(group=None, size=size, rank=rank)


@pytest.mark.parametrize("rank", range(JAX_MESH))
def test_shard_particles_matches_jax(rank):
    """``shard_particles`` keeps the block of the JAX package's shard on
    device ``rank`` (rows over the mesh), and whole what it replicates (a
    scalar, a ragged array)."""
    import jax.numpy as jnp

    from aspire_tpu.parallel.mesh import make_mesh, shard_particles

    rng = np.random.default_rng(42)
    tree = {"x": rng.normal(size=(64, 3)), "scalar": np.asarray(1.0),
            "ragged": rng.normal(size=(13,))}
    want = shard_particles({k: jnp.asarray(v) for k, v in tree.items()},
                           make_mesh(JAX_MESH))
    got = M.shard_particles(tree, _fake_mesh(JAX_MESH, rank))
    shard = {s.device.id: s for s in want["x"].addressable_shards}
    np.testing.assert_array_equal(got["x"].numpy(),
                                  np.asarray(shard[rank].data))
    assert want["scalar"].sharding.is_fully_replicated
    assert want["ragged"].sharding.is_fully_replicated
    for k in ("scalar", "ragged"):
        np.testing.assert_array_equal(got[k].numpy(), tree[k])


@pytest.mark.parametrize("n", [13, 16])
def test_pad_to_shards_matches_jax(n):
    from aspire_tpu.parallel.mesh import make_mesh, pad_to_shards

    x = np.arange(2 * n, dtype=np.float64).reshape(n, 2)
    want, n_want = pad_to_shards(np.asarray(x), make_mesh(JAX_MESH))
    got, n_got = M.pad_to_shards(x, _fake_mesh(JAX_MESH, 0))
    assert n_got == n_want == n
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sharding_descriptors():
    mesh = _fake_mesh(4, 1)
    assert not M.particle_sharding(mesh).replicated
    assert M.replicated_sharding(mesh).replicated
    assert M.particle_sharding(mesh).mesh is mesh


def test_single_process_start_is_a_no_op():
    """As in the JAX package, one process starts no process group; a mesh
    needs one."""
    import torch.distributed as dist

    M.initialize_distributed(num_processes=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        M.make_mesh(device="cpu")


# -- the ranks' results ----------------------------------------------------


@pytest.mark.parametrize("size", RANKS)
def test_mesh_of_the_process_group(jobs, size):
    assert [r["mesh"] for r in jobs[size]] == [
        (size, r, "gloo", "cpu") for r in range(size)]


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("n_out", N_OUTS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("impl", ["ring", "alltoall"])
def test_movement_matches_jax_bit_for_bit(jobs, jax_side, impl, method,
                                          n_out, size):
    """Given the JAX package's index, the port's movement step on ``size``
    ranks gives the JAX package's ring and all-to-all rows on its 8-device
    mesh and ``data[idx]``, bit for bit."""
    k = (method, n_out)
    got = _joined(jobs[size], (impl,) + k)
    _, x, _ = _inputs()
    np.testing.assert_array_equal(got, x[jax_side["idx"][k]])
    np.testing.assert_array_equal(got, jax_side[impl][k])
    if impl == "alltoall":
        assert not any(r[(impl,) + k][1] for r in jobs[size])


@pytest.mark.parametrize("size", RANKS)
def test_alltoall_overflow_takes_the_ring(jobs, jax_side, size):
    """All weight on one particle overflows the buckets (of 16 rows): the
    all-to-all takes the ring (S - 1 shifts, no all-to-all) on every rank
    and still gives ``data[idx]`` and the JAX package's fallback rows."""
    _, x, _ = _inputs()
    got = _joined(jobs[size], "overflow")
    np.testing.assert_array_equal(got, x[jax_side["idx_deg"]])
    np.testing.assert_array_equal(got, jax_side["a2a_deg"])
    for r in jobs[size]:
        _, took_ring, counts = r["overflow"]
        assert took_ring and counts == {"shift": size - 1}


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("impl", ["auto", "ring", "alltoall"])
def test_primitive_counts_tell_the_schedules_apart(jobs, impl, size):
    """A resampling of ``SMCSamples`` on the mesh: one gather of the
    weights, then the ring's S - 1 shifts, the all-to-all's one exchange,
    or ``"auto"``'s gather of the rows (one per dtype); the rows are the
    same for every schedule."""
    counts = [r[("samples", impl)][2] for r in jobs[size]]
    want = {"ring": {"all_gather": 1, "shift": size - 1},
            "alltoall": {"all_gather": 1, "all_to_all": 1},
            "auto": {"all_gather": 1, "all_gather_rows": 1}}[impl]
    assert counts == [want] * size
    auto = _joined(jobs[size], ("samples", "auto"))
    np.testing.assert_array_equal(_joined(jobs[size], ("samples", impl)),
                                  auto)


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("impl", ["ring", "alltoall"])
def test_resample_matrix_is_the_gather_of_its_index(jobs, impl, size):
    """The port's ``*_resample_matrix`` (its own index from the gathered
    weights) equals ``data[idx]`` of the one-process index on the same
    generator seed, with one weight gather and the schedule's moves."""
    lw, x, _ = _inputs()
    idx = TR.get_resampler("systematic")(torch.Generator().manual_seed(5),
                                         torch.as_tensor(lw))
    np.testing.assert_array_equal(_joined(jobs[size], ("schedule", impl)),
                                  x[idx.numpy()])
    want = ({"all_gather": 1, "shift": size - 1} if impl == "ring"
            else {"all_gather": 1, "all_to_all": 1})
    assert all(r[("schedule", impl)][1] == want for r in jobs[size])


@pytest.mark.parametrize("size", RANKS)
@pytest.mark.parametrize("impl", ["ring", "alltoall"])
def test_n_out_must_tile_the_mesh(jobs, jax_side, impl, size):
    """The JAX package's ``ValueError`` for an ``n_out`` the mesh does not
    tile, its words with the mesh size in them."""
    want = jax_side["errors"][impl].replace(f"({JAX_MESH})", f"({size})")
    assert "divisible by the mesh" in want
    assert [r[("error", impl)] for r in jobs[size]] == [want] * size


@pytest.mark.parametrize("size", RANKS)
def test_primitives(jobs, size):
    """The gather is the blocks in rank order; a reduction is the same on
    every rank (integers by the backend, a float sum in rank order)."""
    _, x, _ = _inputs()
    for r in jobs[size]:
        np.testing.assert_array_equal(r["gathered"].numpy(), x)
        total, half = r["reduced"]
        assert int(total) == size * (size + 1) // 2
        assert float(half) == sum(0.5 * k for k in range(size))


def test_ring_without_mesh_raises_as_in_jax():
    """``SMCSamples.resample(impl="ring")`` of a population on one device:
    the JAX package's ``ValueError``, word for word."""
    import jax
    import jax.numpy as jnp

    from aspire_tpu.samples import SMCSamples as JSMCSamples
    from aspire_tpu_torch.samples import SMCSamples

    lw, x, _ = _inputs()
    jpop = JSMCSamples(x=jnp.asarray(x), beta=0.2)
    jpop.log_likelihood = jpop.log_prior = jpop.log_q = jnp.asarray(lw)
    pop = SMCSamples(x=x, beta=0.2)
    pop.log_likelihood = pop.log_prior = pop.log_q = lw
    for impl in ("ring", "alltoall", "nonsense"):
        with pytest.raises(ValueError) as want:
            jpop.resample(0.6, key=jax.random.key(0), impl=impl)
        with pytest.raises(ValueError) as got:
            pop.resample(0.6, torch.Generator(), impl=impl)
        assert str(got.value) == str(want.value)
        assert impl == "nonsense" or re.search("mesh-sharded",
                                               str(got.value))
