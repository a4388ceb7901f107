"""EC-axis data parallelism across devices and processes (counterpart of
msweep_tpu/parallel/mesh.py).

The EC axis is cut into contiguous row ranges, one per shard, and the
small group axis is replicated (inference/pack.py).  Every pass runs its
kernel on each shard and adds the O(G) sufficient statistics: across the
shards of one process on the first shard's device, across processes with
one all_reduce(SUM) on the torch.distributed process group (NCCL between
GPUs, gloo on the CPU).  The reference's MPI build sharded the same axis
across ranks with root-only I/O (docs/compilation.md:40-58 upstream).

Nothing here tells a process of a cluster: init_distributed is given the
coordinator's address, the number of processes and this process's id.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def ec_devices(n_shards: int, device: torch.device | str) -> list | None:
    """The first n_shards devices of `device`'s type (0 = every visible
    one), or None when that is one device: no sharding."""
    device = torch.device(device)
    if device.type == "cuda":
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        visible = [device]
    n = len(visible) if n_shards in (0, None) else int(n_shards)
    if n <= 1:
        return None
    if n > len(visible):
        raise ValueError(f"requested {n} shards but only {len(visible)} devices")
    return visible[:n]


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     device: torch.device | str, backend: str | None = None):
    """Join the process group at tcp://coordinator (host:port; process 0
    listens there) as process `process_id` of `num_processes`.  The backend
    is NCCL for a CUDA device and gloo for the CPU; `backend` overrides it
    for library callers (gloo lets two processes share one card, NCCL
    refuses that).  Returns (rank, world size)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=num_processes, rank=process_id,
    )
    return dist.get_rank(), dist.get_world_size()


def process_group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank_and_size() -> tuple[int, int]:
    """(rank, world size) of the process group; (0, 1) without one."""
    if not process_group_up():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def _comm_device(t: torch.Tensor) -> torch.device:
    """NCCL reduces device tensors; gloo goes through the host."""
    return t.device if dist.get_backend() == "nccl" else torch.device("cpu")


def all_reduce_sum(tensors: list) -> list:
    """The elementwise sums of `tensors` (float64) over all processes, in
    one all_reduce, returned on the tensors' devices.  The result is the
    same on every process, so host branches on it agree."""
    dev = tensors[0].device
    flat = torch.cat([t.reshape(-1) for t in tensors])
    buf = flat.to(_comm_device(flat))
    dist.all_reduce(buf)
    flat = buf.to(dev)
    out, k = [], 0
    for t in tensors:
        out.append(flat[k:k + t.numel()].reshape(t.shape))
        k += t.numel()
    return out


def broadcast_from_root(value: int) -> int:
    """Process 0's `value` on every process (a no-op without a group)."""
    if not process_group_up():
        return value
    buf = torch.tensor([value], dtype=torch.int64)
    if dist.get_backend() == "nccl":
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    dist.broadcast(buf, src=0)
    return int(buf[0])


def to_host(t: torch.Tensor) -> np.ndarray | None:
    """A tensor on the host.  In a distributed run t holds this process's
    rows of a row-sharded tensor: process 0 gets every process's rows in
    process order, the others None."""
    if not process_group_up():
        return t.cpu().numpy()
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = _comm_device(t)
    t = t.to(dev).contiguous()
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(world)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    padded = torch.zeros((max(sizes), *t.shape[1:]), dtype=t.dtype, device=dev)
    padded[: t.shape[0]] = t
    bufs = [torch.empty_like(padded) for _ in range(world)] if rank == 0 else None
    dist.gather(padded, bufs, dst=0)
    if rank != 0:
        return None
    return torch.cat([b[:s] for b, s in zip(bufs, sizes)]).cpu().numpy()
