"""Multi-process parallelism over the particle axis (``torch.distributed``;
:mod:`.mesh` gives the model of execution)."""

from .mesh import (  # noqa: F401
    get_mesh,
    initialize_distributed,
    make_mesh,
    particle_sharding,
    replicated_sharding,
    shard_particles,
)
