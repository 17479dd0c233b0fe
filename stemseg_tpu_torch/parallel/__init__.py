"""Data parallelism over ``torch.distributed``: the process group is the
JAX mesh's "data" axis, one rank per device."""

from stemseg_tpu_torch.parallel.mesh import (  # noqa: F401
    all_reduce_sum_,
    replicate,
    shard_batch,
)
