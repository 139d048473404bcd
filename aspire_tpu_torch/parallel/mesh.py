"""The particle axis over a mesh of processes (counterpart of
``aspire_tpu/parallel/mesh.py``), on ``torch.distributed``.

The JAX package shards one program's ``(n, d)`` arrays over a device mesh
and lets XLA insert the collectives; its multi-controller form runs one
process per host. The port runs one process per card, SPMD:

- **Every rank runs the same script** (as under ``torchrun``): the same
  flow, the same seed, and its own contiguous block of ``n / S`` rows of
  every particle array (``S`` ranks; rank ``r`` holds rows ``[r n / S,
  (r + 1) n / S)``).
- **Every rank's generator stays in the one-process run's state.** Each
  random draw the one-process run makes at ``(n, ...)`` is made at that
  full shape on every rank, which keeps its own rows (the chains' normals
  and uniforms, tpCN's Gamma variates, the flow's latent draws); draws of
  no particle shape (the resampling offset, a coin) are made as they are.
  The initial population is drawn whole on every rank and then sharded,
  the JAX package's order. So a sharded run makes the one-process run's
  draws, at the cost of ``n d`` normals a chain step on every rank.
- **Global reductions** (the beta bisection and the ESS, the evidence
  increments, the Gaussian reference's moments, the windowed tau, the
  acceptance rate) are computed by every rank from all-gathered vectors
  or rows, in the one-process summation order, so beta and log Z are the
  same on every rank bit for bit. Counts are all-reduced as integers.
- **The result** of a run is the whole population on every rank (one
  all-gather at the end, the JAX package's global array).
- **The flow is replicated**: a sampler on a mesh of more than one rank
  checks once per run that every rank's flow parameters and data
  transform are bit-identical, and raises where they are not.

The backend is chosen explicitly: NCCL for the card and gloo for the CPU by
default, gloo on the card where the caller asks for it; a collective that
fails raises. Nothing falls back to one process or to the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import logging
import os
from typing import Any

import torch

logger = logging.getLogger("aspire_tpu_torch")

#: how long a collective (and the rendezvous) waits before it raises: a
#: rank that fails while the others wait in a collective ends the run
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)

#: the primitives' calls, by name, since the last reset: the resampling
#: schedules read apart by them (``"all_gather"`` of vectors,
#: ``"all_gather_rows"`` of matrices, ``"all_reduce"``, ``"shift"``,
#: ``"all_to_all"``, ``"barrier"``). A collective captured in a CUDA graph
#: is counted at each replay, not at the capture
#: (:func:`captured_collectives`, :func:`add_collectives`).
collective_counts: collections.Counter = collections.Counter()

_MESH: "ProcessMesh | None" = None


def _dist():
    import torch.distributed as dist

    return dist


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           backend: str | None = None,
                           init_method: str | None = None) -> None:
    """Join the process group (the JAX package's ``jax.distributed``
    start-up): a no-op for one process unless ``init_method`` is given.

    ``num_processes`` and ``process_id`` default to ``torchrun``'s
    ``WORLD_SIZE`` and ``RANK``; the rendezvous is ``init_method`` (say
    ``"file:///shared/rdv"``), else ``tcp://coordinator_address``, else
    ``torchrun``'s environment (``env://``). ``backend`` defaults to NCCL
    where CUDA is available and gloo where it is not; gloo on the card is
    had by asking for it."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if num_processes <= 1 and init_method is None:
        logger.debug("Single-process run; no process group started")
        return
    if init_method is None:
        init_method = (f"tcp://{coordinator_address}"
                       if coordinator_address is not None else "env://")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    _dist().init_process_group(backend, init_method=init_method,
                               world_size=num_processes, rank=process_id,
                               timeout=DEFAULT_TIMEOUT)
    logger.info("Joined the %s process group: rank %d of %d", backend,
                process_id, num_processes)


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh:
    """A 1-D mesh of ranks over the particle axis: the process group, its
    size, this process's rank in it, the axis name, the backend and the
    rank's device."""

    group: Any
    size: int
    rank: int
    axis_name: str = "data"
    backend: str = "gloo"
    device: torch.device = torch.device("cpu")

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the rows of ``x`` (a whole population)."""
        m = x.shape[0] // self.size
        return x[self.rank * m:(self.rank + 1) * m]


def _mesh_device(device: Any, backend: str) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass "
                               "device='cpu' for a CPU mesh over gloo)")
        local = int(os.environ.get("LOCAL_RANK", _dist().get_rank()))
        device = torch.device("cuda", local % count)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not "
                         f"{device}")
    return device


def make_mesh(n_devices: int | None = None, axis_name: str = "data", *,
              device: Any = None) -> ProcessMesh:
    """A mesh over the first ``n_devices`` ranks (all by default) of the
    started process group (:func:`initialize_distributed`). Every rank
    calls it; a rank outside the mesh raises. The rank's device is
    ``device``, by default the card ``cuda:{LOCAL_RANK % device_count}``;
    a card becomes the process's current device (as under ``torchrun``),
    so a bare ``"cuda"`` and every kernel launch mean the rank's card."""
    dist = _dist()
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "initialize_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    size = world if n_devices is None else int(n_devices)
    if not 1 <= size <= world:
        raise ValueError(f"n_devices={n_devices} on a world of {world} ranks")
    backend = str(dist.get_backend())
    device = _mesh_device(device, backend)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    group = (dist.group.WORLD if size == world
             else dist.new_group(list(range(size))))
    if rank >= size:
        raise ValueError(f"rank {rank} is outside the mesh of the first "
                         f"{size} ranks")
    return ProcessMesh(group=group, size=size, rank=rank,
                       axis_name=axis_name, backend=backend, device=device)


def _run_rank(rank: int, fn, *args) -> None:
    """``fn(rank, *args)`` in a rank of :func:`spawn_ranks`, then, where
    ``fn`` left its process group started, the group left together: a
    barrier (no rank closes its connections while a peer's last exchange
    is on the wire, which aborted that peer) and ``destroy_process_group``
    (after a collection, so no captured ladder holds NCCL's communicator,
    ROADMAP C19)."""
    import gc

    fn(rank, *args)
    dist = _dist()
    if dist.is_initialized():
        gc.collect()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        barrier()
        dist.destroy_process_group()


def spawn_ranks(fn, size: int, args: tuple = (),
                timeout: float = 600.0) -> None:
    """Run ``fn(rank, *args)`` in ``size`` ``spawn`` processes on this host
    (``torchrun``'s work, for a script or a test that starts its own
    ranks; ``fn`` sits at a module's top level) and wait at most
    ``timeout`` seconds for all of them. A rank that raises or exits
    non-zero ends the others and raises here, as does the timeout; no
    process is left running. The ranks' gloo traffic stays on the
    loopback interface unless ``GLOO_SOCKET_IFNAME`` says otherwise: on a
    host with another interface, gloo's own choice let ranks of several
    jobs started at once abort (``std::terminate``)."""
    import time

    import torch.multiprocessing as mp

    saved = os.environ.get("GLOO_SOCKET_IFNAME")
    os.environ["GLOO_SOCKET_IFNAME"] = saved or "lo"
    try:
        ctx = mp.start_processes(_run_rank, args=(fn, *args), nprocs=size,
                                 join=False, start_method="spawn")
    finally:
        if saved is None:
            del os.environ["GLOO_SOCKET_IFNAME"]
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{size} ranks did not finish in "
                                   f"{timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def get_mesh(axis_name: str = "data") -> ProcessMesh:
    """The process-wide default mesh (over every rank, made at first
    use)."""
    global _MESH
    if _MESH is None:
        _MESH = make_mesh(axis_name=axis_name)
    return _MESH


def set_mesh(mesh: ProcessMesh | None) -> None:
    global _MESH
    _MESH = mesh


@dataclasses.dataclass(frozen=True, eq=False)
class Sharding:
    """Where an array lives: a block of its ``axis`` per rank
    (``replicated=False``; axis 0, the rows, for particle arrays) or the
    whole array on every rank."""

    mesh: ProcessMesh
    axis_name: str = "data"
    replicated: bool = False
    axis: int = 0


def particle_sharding(mesh: ProcessMesh,
                      axis_name: str = "data") -> Sharding:
    """``(n, ...)`` particle arrays: a block of rows per rank."""
    return Sharding(mesh, axis_name)


def replicated_sharding(mesh: ProcessMesh) -> Sharding:
    return Sharding(mesh, mesh.axis_name, replicated=True)


def walker_sharding(mesh: ProcessMesh, axis_name: str = "data") -> Sharding:
    """``(T, n, ...)`` tempered ensembles: a block of the walkers (axis 1)
    per rank, the temperature axis whole (the parallel-tempering sampler's:
    the tempered sweeps evaluate each rank's walkers, the swaps stay on the
    rank)."""
    return Sharding(mesh, axis_name, axis=1)


def shard_particles(tree, mesh: ProcessMesh, axis_name: str = "data"):
    """This rank's rows of every array in ``tree`` (dicts, lists and tuples
    of arrays) whose leading axis divides by the mesh size; any other leaf
    (a scalar, a ragged array) is kept whole."""
    del axis_name  # one axis

    def place(leaf):
        t = torch.as_tensor(leaf)
        if t.dim() >= 1 and t.shape[0] % mesh.size == 0:
            return mesh.local_rows(t)
        return t

    if isinstance(tree, dict):
        return {k: shard_particles(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_particles(v, mesh) for v in tree)
    return place(tree)


def pad_to_shards(x, mesh: ProcessMesh):
    """Pad the leading axis up to a multiple of the mesh size by repeating
    the last row; returns ``(padded, n_valid)``."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    rem = (-n) % mesh.size
    if rem == 0:
        return x, n
    return torch.cat([x, x[-1:].expand(rem, *x.shape[1:])]), n


# -- the collective primitives ------------------------------------------


def all_gather_rows(block: torch.Tensor, mesh: ProcessMesh,
                    counts: list[int] | None = None) -> torch.Tensor:
    """Every rank's block, concatenated in rank order (the whole
    population). ``counts`` gives each rank's row count where the blocks
    differ in length (each padded to the longest for the exchange)."""
    collective_counts["all_gather" if block.dim() <= 1
                      else "all_gather_rows"] += 1
    block = block.contiguous()
    if counts is not None:
        pad = max(counts) - block.shape[0]
        if pad:
            block = torch.cat([block, block.new_zeros(pad, *block.shape[1:])])
    parts = [torch.empty_like(block) for _ in range(mesh.size)]
    _dist().all_gather(parts, block, group=mesh.group)
    if counts is not None:
        parts = [p[:c] for p, c in zip(parts, counts)]
    return torch.cat(parts)


def all_reduce(x: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """The sum over the ranks, the same bits on every rank. Integers are
    summed by the backend (exact); a float sum is the gathered values
    summed in rank order, so every rank holds the same value whatever
    order the backend would add in."""
    collective_counts["all_reduce"] += 1
    if x.is_floating_point():
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        _dist().all_gather(parts, x.contiguous(), group=mesh.group)
        return torch.stack(parts).sum(0)
    out = x.to(torch.int64).clone()
    _dist().all_reduce(out, group=mesh.group)
    return out.to(x.dtype)


def _exchange(send: torch.Tensor, mesh: ProcessMesh, in_splits,
              out_splits, out_rows: int) -> torch.Tensor:
    out = send.new_empty((out_rows, *send.shape[1:]))
    _dist().all_to_all_single(out, send.contiguous(),
                              output_split_sizes=out_splits,
                              input_split_sizes=in_splits, group=mesh.group)
    return out


def shift(block: torch.Tensor, mesh: ProcessMesh,
          step: int = 1) -> torch.Tensor:
    """Pass ``block`` ``step`` ranks on round the ring and take the one
    coming from ``step`` ranks back (the JAX package's ``ppermute`` with
    one pair a rank): one ``all_to_all_single`` with one non-zero split
    each way, so NCCL and gloo take CUDA tensors alike. Every rank's block
    has the same shape."""
    collective_counts["shift"] += 1
    s, r, m = mesh.size, mesh.rank, block.shape[0]
    in_splits, out_splits = [0] * s, [0] * s
    in_splits[(r + step) % s] = m
    out_splits[(r - step) % s] = m
    return _exchange(block, mesh, in_splits, out_splits, m)


def all_to_all(send: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """``send[t]`` goes to rank ``t``; returns ``recv`` with ``recv[s]``
    what rank ``s`` sent this one (``send`` is ``(S, ...)``)."""
    collective_counts["all_to_all"] += 1
    rows = [send.shape[1]] * mesh.size
    flat = send.reshape(mesh.size * send.shape[1], *send.shape[2:])
    out = _exchange(flat, mesh, rows, rows, flat.shape[0])
    return out.reshape(send.shape)


def barrier(mesh: ProcessMesh | None = None) -> None:
    """Wait until every rank of ``mesh`` (every rank of the started
    process group where None) has reached it: one integer all-reduce on
    the mesh's device, read back on the host. A checkpoint's writers meet
    here once every rank's file is closed."""
    dist = _dist()
    if mesh is None:
        if not dist.is_initialized() or dist.get_world_size() == 1:
            return
        device = (torch.device("cuda", torch.cuda.current_device())
                  if str(dist.get_backend()) == "nccl"
                  else torch.device("cpu"))
        group = dist.group.WORLD
    else:
        device, group = mesh.device, mesh.group
    collective_counts["barrier"] += 1
    flag = torch.ones(1, dtype=torch.int64, device=device)
    dist.all_reduce(flag, group=group)
    int(flag.item())


def process_index() -> int:
    """This process's rank in the started process group (0 without
    one): the JAX package's ``jax.process_index``."""
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The started process group's size (1 without one)."""
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def reset_collective_counts() -> None:
    collective_counts.clear()


def captured_collectives(before: dict) -> collections.Counter:
    """The collectives counted since ``before`` (a copy of
    :data:`collective_counts` taken just before a CUDA graph's capture),
    taken back off the counts: a capture runs nothing. Each replay of the
    graph adds them (:func:`add_collectives`)."""
    made = collections.Counter(collective_counts)
    made.subtract(before)
    made = +made
    collective_counts.subtract(made)
    for name in [k for k, v in collective_counts.items() if v <= 0]:
        del collective_counts[name]
    return made


def add_collectives(made: dict) -> None:
    """Add one replay's collectives (:func:`captured_collectives`)."""
    collective_counts.update(made)
