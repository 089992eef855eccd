"""Multi-device scaling: particle meshes, shardings, distributed init."""
from .mesh import (
    PARTICLE_AXIS,
    make_particle_mesh,
    particle_sharding,
    replicated,
    shard_population,
)

__all__ = [
    "PARTICLE_AXIS", "make_particle_mesh", "particle_sharding",
    "replicated", "shard_population",
]
