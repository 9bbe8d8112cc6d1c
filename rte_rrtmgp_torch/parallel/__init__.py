"""Column and g-point sharding of the radiation pipeline over devices and
processes (counterpart of the JAX package's ``parallel/``)."""

from .mesh import (Mesh, Placed, make_mesh, column_spec, shard_atmosphere,
                   shard_kdist, replicate)

__all__ = ["Mesh", "Placed", "make_mesh", "column_spec", "shard_atmosphere",
           "shard_kdist", "replicate"]
