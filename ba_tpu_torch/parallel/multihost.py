"""Several processes (``ba_tpu/parallel/multihost.py``): join a
``torch.distributed`` process group, build a (data, node) mesh over every
process's devices, and hand each process its shards of a value.

Axis policy, as the reference's: "data" (independent instances, whose
only per-round traffic is a 3-int histogram sum) spans processes, and
"node" (the generals of one cluster, whose all-gathers are hot) stays on
each process's own devices.  Collectives over "data" on such a mesh go
through the group: NCCL when the devices are CUDA (one rank a GPU: NCCL
cannot put two ranks on one), gloo on the CPU.  With one process and no
group every helper degenerates to its single-process form.
"""

from __future__ import annotations

import numpy as np
import torch

from ba_tpu_torch.core.om import round1_broadcast
from ba_tpu_torch.core.state import SimState, resolve_device
from ba_tpu_torch.parallel.mesh import DEFAULT_AXES, Mesh, gather_tree, put_global


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> int:
    """Join the process group; returns the process count.

    With no address and at most one process it is a no-op returning 1,
    as the reference's.  Otherwise ``torch.distributed.init_process_group``
    with the explicit method ``tcp://<coordinator_address>`` (host:port;
    never ``env://``), ``num_processes`` ranks and this ``process_id``:
    NCCL when ``device`` (default: the card) is CUDA, and it raises when
    this torch has no NCCL; gloo on the CPU.
    """
    if coordinator_address is None and num_processes in (None, 1):
        return 1
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator_address, num_processes and "
                         "process_id together")
    import torch.distributed as dist

    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a CUDA process group needs it")
        backend = "nccl"
    else:
        backend = "gloo"
    method = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    if not method.startswith("tcp://"):
        raise ValueError(f"init method {method!r}: the port joins by tcp:// only")
    dist.init_process_group(backend, init_method=method, world_size=num_processes,
                            rank=process_id)
    return dist.get_world_size()


def make_global_mesh(node_devices_per_host: int = 1, axis_names: tuple = DEFAULT_AXES,
                     devices=None) -> Mesh:
    """A (data, node) mesh over every process's devices.

    ``devices`` are this process's entries (default: its visible CUDA
    devices; an entry may repeat a device).  Each process's entries stay
    contiguous on "node" (``node_devices_per_host`` of them a row, which
    must divide the local count); "data" spans the processes times the
    remaining local entries, ordered by (process, local ordinal).  In a
    process group every rank must call it; the mesh keeps the group, and
    each rank owns its own rows.  Without a group it is ``make_mesh`` over
    the local devices.
    """
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if grouped:
        every: list = [None] * dist.get_world_size()
        dist.all_gather_object(every, local)
        rank = dist.get_rank()
    else:
        every, rank = [local], 0
    per_host = {len(d) for d in every}
    if len(per_host) != 1:
        raise ValueError(f"heterogeneous hosts unsupported: device counts {sorted(per_host)}")
    n_local = per_host.pop()
    if node_devices_per_host > n_local or n_local % node_devices_per_host:
        raise ValueError(f"node_devices_per_host={node_devices_per_host} must divide "
                         f"local device count {n_local}")
    flat = sorted((p, i, d) for p, devs in enumerate(every) for i, d in enumerate(devs))
    data = len(every) * (n_local // node_devices_per_host)
    arr = np.empty((data, node_devices_per_host), dtype=object)
    owners = np.empty((data, node_devices_per_host), np.int64)
    for k, (p, _, d) in enumerate(flat):
        pos = (k // node_devices_per_host, k % node_devices_per_host)
        arr[pos], owners[pos] = torch.device(d), p
    return Mesh(arr, axis_names, owners=owners, rank=rank,
                group=dist.group.WORLD if grouped else None)


def round1(key_data: torch.Tensor, state: SimState) -> torch.Tensor:
    """The round-1 broadcast of the whole batch under ``key_data`` (the
    reference's ``round1_jit``, which exists so a global state may enter
    a trace; here a sharded state is gathered first)."""
    state = gather_tree(state)
    return round1_broadcast(key_data.to(state.device), state)


__all__ = ["init_distributed", "make_global_mesh", "put_global", "round1"]
