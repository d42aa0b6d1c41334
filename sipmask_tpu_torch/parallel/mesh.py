"""Process groups for data-parallel training and sharded evaluation, the
port of ``sipmask_tpu/parallel/mesh.py``.

The JAX package writes its train step once as global-batch SPMD over a
device mesh, and XLA puts in the gradient all-reduce and the loss's global
normalisers. The port runs one process a device (``torchrun``, or explicit
``--coordinator/--num-processes/--process-id`` as the JAX CLIs take them),
each with its shard of the global batch: ``compute_losses`` divides by
normalisers summed over the ranks (:func:`global_sum`), so that each rank's
loss is its share of the global batch's loss, and ``make_train_step`` sums
the ranks' gradients (:func:`all_reduce_sum_`) before the clip and the
update. The sum of the ranks' gradients is then the global loss's gradient,
as one process on the global batch computes it.

Without a process group every function here leaves the numbers alone, and
the callers run the code they ran on one device. With one, they run the
reductions at any world size: at world 1 each is the identity. Nothing
falls back: a backend that does not start, or a collective that fails,
raises.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

# A rank-0-only evaluation (SipMask-VIS tracks on rank 0) keeps the other
# ranks at a barrier of the host group for its whole length: that group's
# timeout has to cover one, the default group's need not.
HOST_TIMEOUT = datetime.timedelta(hours=4)

# set by init_distributed: the rank's local index and the host group (gloo,
# over CPU tensors: barriers and the pickled result transport)
_STATE = {"local_rank": 0, "host": None}


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> torch.device:
    """Join the process group and return this rank's device.

    With no arguments the group is read from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``); ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` give it explicitly. The backend is
    ``nccl`` when ``device`` is CUDA and ``gloo`` on the CPU, unless
    ``backend`` names one (two ranks on one card need ``gloo``: NCCL takes
    one rank a device). Raises if the group cannot start; never goes on at
    world 1 or on another backend. A second call, once a group exists,
    returns the device and changes nothing."""
    device = torch.device(device)
    if dist.is_initialized():
        return rank_device(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        rank, world = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"init_distributed: {missing} not in the environment (launch "
                f"with torchrun) and no coordinator address given")
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    local = int(os.environ.get("LOCAL_RANK", rank))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: device cuda, but "
                               "torch.cuda.is_available() is False")
        local %= torch.cuda.device_count()
        torch.cuda.set_device(local)
    _STATE["local_rank"] = local
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    _STATE["host"] = dist.new_group(backend="gloo", timeout=HOST_TIMEOUT)
    return rank_device(device)


def destroy_distributed() -> None:
    """Leave the process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(local_rank=0, host=None)


def active() -> bool:
    """Whether a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_shard_args():
    """(rank, world): this process's shard of the data and the number of
    shards; (0, 1) without a process group."""
    if not active():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` for CUDA, else ``device``."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", _STATE["local_rank"] if active() else
                        (device.index or 0))


def global_sum(*scalars):
    """Each 0-d tensor summed over the ranks, detached, in its own dtype
    (one all-reduce of them stacked in float64, exact for counts and for
    f32 sums); the inputs themselves without a process group."""
    if not active():
        return scalars
    stacked = torch.stack([s.detach().to(torch.float64) for s in scalars])
    dist.all_reduce(stacked)
    return tuple(v.to(s.dtype) for v, s in zip(stacked.unbind(), scalars))


def all_reduce_sum_(params, scalars):
    """Sum the gradients of ``params`` and the 0-d tensors ``scalars`` over
    the ranks, in place, in one all-reduce of one flat f32 buffer; returns
    the summed scalars. A parameter without a gradient on this rank adds
    zeros and a flag that rides in the same buffer: it gets the sum if any
    rank has a gradient for it, and keeps none if no rank has, as in one
    process (the flags are read back to the host only when this rank lacks
    a gradient). Without a process group: ``scalars``, and the gradients as
    they are."""
    if not active():
        return list(scalars)
    params = list(params)
    dev = params[0].device
    local = [p.grad is not None for p in params]
    # the flags made on the device where every gradient is here: a list
    # copied from the host would wait for the backward
    flags = (torch.ones(len(params), device=dev) if all(local) else
             torch.tensor(local, dtype=torch.float32, device=dev))
    flat = torch.cat(
        [p.grad.detach().reshape(-1).float() if h
         else torch.zeros(p.numel(), device=dev)
         for p, h in zip(params, local)]
        + [flags, torch.stack([s.detach().float() for s in scalars])])
    dist.all_reduce(flat)
    n = sum(p.numel() for p in params)
    anyone = (local if all(local) else
              [bool(f) for f in flat[n:n + len(params)].cpu().tolist()])
    offset = 0
    for p, h in zip(params, anyone):
        part = flat[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
        if p.grad is not None:
            p.grad.copy_(part)
        elif h:
            p.grad = part.to(p.dtype).clone()
    return list(flat[n + len(params):].unbind())


def barrier() -> None:
    """Wait for every rank on the host group (its timeout covers a rank-0
    evaluation); nothing without a process group."""
    if active():
        dist.barrier(group=_STATE["host"])


def host_group():
    """The gloo group for host objects and barriers (None: the default
    group, where the caller made the process group itself)."""
    return _STATE["host"]
