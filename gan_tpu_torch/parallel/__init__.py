"""Data parallelism of the port (counterpart of gan_tpu/parallel): replicas
on torch.distributed, one process per device."""

from gan_tpu_torch.parallel.mesh import (Replicas, join, launch, leave, replica_mean, single,
                                         stripe_rows, world_size)

__all__ = ["Replicas", "join", "launch", "leave", "replica_mean", "single", "stripe_rows",
           "world_size"]
