"""Parallelism over the pair axis: a list of devices, a shard a device."""

from .sharding import (PairMesh, Sharded, contact_count_sharded,
                       gjkepa_batch_fused_sharded, gjkepa_batch_sharded,
                       pair_mesh, shard_pairs)

__all__ = ["PairMesh", "Sharded", "contact_count_sharded",
           "gjkepa_batch_fused_sharded", "gjkepa_batch_sharded", "pair_mesh",
           "shard_pairs"]
