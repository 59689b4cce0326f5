"""Data parallelism on torch.distributed, the port's counterpart of the JAX
package's ``parallel/mesh.py``.

One process a device, each fed its own rows of the global batch; the
parameters are the same on every rank (`replicate` broadcasts them from
rank 0), and `make_train_step(mesh=...)` averages the gradients over the
group in bucketed all-reduces after the backward. The JAX package's sharded
step is GSPMD: it computes the loss and the BatchNorm statistics of the one
global batch. So do the port's ranks, through `data_parallel(group)`, which
the step enters around its forward and loss:

- `batch_norm_train` all-reduces the batch sums (`all_reduce_sum`, whose
  backward all-reduces the gradient), so every rank normalises with the
  global batch statistics and moves the running statistics by them;
- the losses' means divide each rank's numerator by the all-reduced count
  and multiply by the world size, so that the average of the ranks'
  gradients is the gradient of the global mean (`mean_share`).

Without `RANK`, `WORLD_SIZE` and `MASTER_ADDR` in the environment (one
process) nothing is initialised, `make_mesh` returns None and the step is
the single-device one.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Any, Mapping

import torch
import torch.distributed as dist

from roma_torch.device import resolve_device

_ACTIVE = threading.local()  # .group: the data-parallel group of the running step


@contextlib.contextmanager
def data_parallel(group):
    """Inside, `active_group()` is `group` (None: one process)."""
    prev = getattr(_ACTIVE, "group", None)
    _ACTIVE.group = group
    try:
        yield
    finally:
        _ACTIVE.group = prev


def active_group():
    return getattr(_ACTIVE, "group", None)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients over the group,
    since every rank's output depends on every rank's input. This is what
    `torch.distributed.nn.functional.all_reduce` computes, but that call
    is deprecated (a FutureWarning in torch 2.13), and the replacement it
    names, `torch.distributed._functional_collectives.all_reduce`, has no
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, differentiable."""
    return _AllReduceSum.apply(x, group)


def mean_share(num: torch.Tensor, count: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """num / (count + eps) with no active group. Under one, this rank's share
    of the global mean: num / (sum of count over the ranks + eps) * world
    size, whose average over the ranks (DDP's gradient average) is the
    global mean. `count`, a tensor on num's device, carries no gradient;
    both ways divide by a tensor, so that one rank computes what no group
    does (a Python divisor rounds differently on the GPU, and the bf16
    backward magnifies one ulp of its seed)."""
    group = active_group()
    if group is None:
        return num / (count + eps)
    total = count.detach().clone()
    dist.all_reduce(total, group=group)
    return num / (total + eps) * dist.get_world_size(group)


def initialize_distributed(device=None) -> tuple[int, int]:
    """(rank, world size). Without `RANK`, `WORLD_SIZE` and `MASTER_ADDR`
    in the environment (one process) a no-op returning (0, 1); otherwise
    the default process group from the environment (as torchrun sets it),
    NCCL on a CUDA `device` (default: the GPU, the process's own by
    `LOCAL_RANK`) and gloo on the CPU."""
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return 0, 1
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def make_mesh(device=None):
    """A one-axis ("data",) DeviceMesh over every rank of the default
    process group, or None when torch.distributed is not initialised (one
    process: the step needs no group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def _device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _to(batch: Mapping[str, Any], device) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def shard_batch(batch: Mapping[str, Any], mesh) -> dict[str, torch.Tensor]:
    """This rank's rows of a global batch (every rank holds all of it),
    the leading axis split evenly over the mesh, on this rank's device."""
    rank, world = mesh.get_local_rank(), mesh.size()
    out = {}
    for k, v in batch.items():
        n = len(v)
        if n % world:
            raise ValueError(f"{k}: a batch of {n} does not split over {world} ranks")
        out[k] = v[rank * n // world:(rank + 1) * n // world]
    return _to(out, _device(mesh))


def global_batch_from_host_local(batch: Mapping[str, Any], mesh) -> dict[str, torch.Tensor]:
    """A rank's own rows (each process loads only its share of the global
    batch, `weighted_pair_iterator(..., host_id=rank)`), on its device. With
    no mesh, the batch as tensors (the step moves them to the model)."""
    if mesh is None:
        return {k: torch.as_tensor(v) for k, v in batch.items()}
    return _to(batch, _device(mesh))


def replicate(state, mesh):
    """Broadcast from rank 0 every tensor of the train state (the model's
    parameters and buffers, the optimizer's state) and its counters, so
    that every rank starts from rank 0's state. A tensor that lives off the
    mesh's device goes through a copy on it, and stays where it was: AdamW
    keeps its step counts on the host (unless capturable or fused), and a
    CUDA mesh's NCCL group broadcasts CUDA tensors only. No-op without a
    mesh."""
    if mesh is None:
        return state
    group, dev = mesh.get_group(), _device(mesh)
    tensors = list(state.model.state_dict().values())
    tensors += [t for s in state.optimizer.state.values() for t in s.values()
                if torch.is_tensor(t)]
    for t in tensors:
        if t.device == dev:
            dist.broadcast(t, 0, group=group)
        else:
            on_dev = t.to(dev)
            dist.broadcast(on_dev, 0, group=group)
            t.copy_(on_dev)
    counters = torch.tensor([state.step, state.updates], device=dev)
    dist.broadcast(counters, 0, group=group)
    state.step, state.updates = (int(c) for c in counters.tolist())
    return state


_BUCKET_BYTES = 25 * 2**20  # DDP's default bucket size


def all_reduce_grads(grads: list[torch.Tensor], group) -> None:
    """Average `grads` over `group` in place: consecutive gradients of one
    dtype flattened into buckets of about `_BUCKET_BYTES`,
    one asynchronous all-reduce a bucket, waited on together (on the GPU
    the wait orders the streams; the host does not block)."""
    world = dist.get_world_size(group)
    buckets: list[list[torch.Tensor]] = []
    size = 0
    for g in grads:
        if not buckets or size >= _BUCKET_BYTES or g.dtype != buckets[-1][0].dtype:
            buckets.append([])
            size = 0
        buckets[-1].append(g)
        size += g.numel() * g.element_size()
    pending = []
    for bucket in buckets:
        flat = torch._utils._flatten_dense_tensors(bucket)
        pending.append((dist.all_reduce(flat, group=group, async_op=True), flat, bucket))
    for work, flat, bucket in pending:
        work.wait()
        flat.div_(world)
        torch._foreach_copy_(bucket, torch._utils._unflatten_dense_tensors(flat, bucket))


def all_reduce_metrics(metrics: dict[str, torch.Tensor], group) -> dict[str, torch.Tensor]:
    """Each metric (a rank's share, `mean_share`) summed over the group and
    divided by the world size: the global value, on every rank."""
    names = list(metrics)
    flat = torch.stack([metrics[k].detach().float() for k in names])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return {k: flat[i] for i, k in enumerate(names)}
