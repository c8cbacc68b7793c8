"""Process groups for the distributed bundle adjustment.

Port of fasttrack_tpu/parallel/multihost.py: tracking streams per host
feeding a shared map, the landmark-sharded Schur BA summed within a
process and across processes. Where the JAX package joins
`jax.distributed` and XLA routes its psum, the port joins a
`torch.distributed` process group and `dist_ba` all-reduces on it:

- `initialize_distributed(...)` joins the group (a coordinator address and
  a process id, or the same environment variables as the JAX package);
- `make_global_mesh()` gives this process's shards on that group;
- `shard_ba_problem(...)` (defined in dist_ba.py) turns the window every
  process holds into this process's landmark slices on its shard devices,
  the cameras replicated.

The backend is NCCL where every process has a card of its own, and gloo
otherwise: for CPU shards, and for processes that share one card, which
NCCL refuses (`tools/torch_bench_multichip.py --processes N`).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.parallel.dist_ba import (  # noqa: F401
    Mesh,
    make_mesh,
    shard_ba_problem,
)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> bool:
    """Join (or skip) a multi-process run.

    The arguments default to the FASTTRACK_COORDINATOR ("host:port"),
    FASTTRACK_NUM_PROCS and FASTTRACK_PROC_ID environment variables. Returns
    False, joining nothing, for one process or no address, so drivers can
    call it unconditionally; True once the group is joined
    (`torch.distributed.init_process_group` at tcp://<address>, which
    raises where it fails). `device` is where this process's shards run
    (None: the card): NCCL when it is a card and every process on the host
    can have one of its own (the process's card is then
    cuda:<process_id mod cards>), gloo otherwise."""
    coordinator_address = coordinator_address or os.environ.get("FASTTRACK_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("FASTTRACK_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("FASTTRACK_PROC_ID", "0"))
    if num_processes <= 1 or coordinator_address is None:
        return False
    dev = resolve(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= num_processes:
        backend = "nccl"
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


def make_global_mesh(axis: str = "map", device=None, n_devices: int | None = None) -> Mesh:
    """This process's shards (`make_mesh(n_devices, axis, device)`; under
    NCCL with no device, the process's own card) on the default process
    group, or on none where no group was joined: then it is `make_mesh`."""
    if not dist.is_initialized():
        return make_mesh(n_devices, axis, device)
    if device is None and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    return dataclasses.replace(make_mesh(n_devices, axis, device), group=dist.group.WORLD)
