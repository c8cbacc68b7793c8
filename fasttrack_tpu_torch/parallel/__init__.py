"""Multi-device bundle adjustment and extraction (port of
fasttrack_tpu/parallel): a window's landmarks shard over a mesh of devices,
their Schur contributions are summed over the shards (and over a
torch.distributed process group), and batches of frames extract shard by
shard."""

from fasttrack_tpu_torch.parallel.dist_ba import (  # noqa: F401
    Mesh,
    SectionTimer,
    distributed_ba_iteration,
    distributed_bundle_adjustment,
    make_mesh,
    sharded_extract_batch,
)
from fasttrack_tpu_torch.parallel.multihost import (  # noqa: F401
    initialize_distributed,
    make_global_mesh,
    shard_ba_problem,
)
