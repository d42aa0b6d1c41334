"""Result collection for sharded evaluation, the port of
``sipmask_tpu/parallel/collect.py``: each rank infers its shard of the set
and the ranks' result lists come back, on every rank, either over the
process group (:func:`collect_results_gather`, the reference's
``collect_results_gpu``) or through part files in a directory every rank
can read (:func:`collect_results_cpu`). Both take any picklable part and
return ``[part_rank0, part_rank1, ...]``; with one process, ``[part]``.
"""

from __future__ import annotations

import os
import pickle

import torch.distributed as dist

from .mesh import barrier, host_group, process_shard_args


def collect_results_gather(part):
    """One picklable object a rank, all-gathered over the host group (gloo
    on CPU tensors, whatever the default backend); the list of every
    rank's part, on every rank."""
    rank, world = process_shard_args()
    if world == 1:
        return [part]
    out = [None] * world
    dist.all_gather_object(out, part, group=host_group())
    return out


def collect_results_cpu(part, tmpdir: str):
    """Through a shared directory: every rank pickles its part into
    ``tmpdir/part_<rank>.pkl``, a barrier, every rank loads all parts, a
    barrier, and rank 0 removes the part files."""
    rank, world = process_shard_args()
    if world == 1:
        return [part]
    os.makedirs(tmpdir, exist_ok=True)
    paths = [os.path.join(tmpdir, f"part_{r}.pkl") for r in range(world)]
    with open(paths[rank], "wb") as f:
        pickle.dump(part, f, protocol=pickle.HIGHEST_PROTOCOL)
    barrier()
    out = []
    for path in paths:
        with open(path, "rb") as f:
            out.append(pickle.load(f))
    barrier()
    if rank == 0:
        for path in paths:
            os.remove(path)
    return out
