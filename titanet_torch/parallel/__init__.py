"""Data parallelism over ranks, one device each (port of
``titanet_tpu/parallel``): :mod:`.distributed` starts the process group
from the launcher's environment and holds the collectives, :mod:`.mesh`
the layout and batch placement, :mod:`.shard_map_step` the explicit
per-rank step of the JAX package's ``shard_map`` variant."""

from titanet_torch.parallel.distributed import (  # noqa: F401
    global_batch_array,
    maybe_initialize_distributed,
)
from titanet_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    batch_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
