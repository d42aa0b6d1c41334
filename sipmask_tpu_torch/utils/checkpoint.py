"""Checkpoints of the port, ``torch.save`` files in place of the JAX
package's orbax directories (``sipmask_tpu/utils/checkpoint.py``).

A checkpoint holds the model's mmdet-named ``state_dict``, the SGD state
(its momentum buffers and param groups), the step and ``meta`` (config,
class names): everything a resumed step needs, the lr schedule included,
since it is a function of the step. ``load_weights`` takes the weights
alone, from such a file or from a bare ``state_dict`` file (the reference's
released ``.pth`` files). ``save_checkpoint`` records the path in
``<dir>/last_checkpoint``, which ``latest_checkpoint`` reads back for
auto-resume. Under a process group rank 0 writes the file and
``last_checkpoint`` and every rank waits at a barrier until they are there,
so any rank may read them back; the model is never wrapped, so the file
holds the same mmdet names whatever the world size, and restores at any
other.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..parallel import barrier, process_shard_args

LAST = "last_checkpoint"


def save_checkpoint(path: str, state, meta: Optional[dict] = None) -> None:
    """Write ``state`` (a ``TrainState``) to ``path`` through a temporary
    file, then point ``last_checkpoint`` beside it at ``path``; under a
    process group, on rank 0, and every rank returns once both are
    written."""
    path = os.path.abspath(path)
    if process_shard_args()[0] == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = dict(state_dict=state.model.state_dict(),
                       optimizer=state.optimizer.state_dict(),
                       step=int(state.step), meta=meta or {})
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        with open(os.path.join(os.path.dirname(path), LAST), "w") as f:
            f.write(path)
    barrier()


def restore_checkpoint(path: str, state):
    """Full resume: weights, SGD state and step, onto the model's device.
    Returns ``state``."""
    dev = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=False)
    state.model.load_state_dict(ckpt["state_dict"])
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.step = int(ckpt["step"])
    return state


def load_weights(path: str, model) -> None:
    """Weights only (the reference's ``load_from``): the ``state_dict`` of
    a checkpoint file, or a file that is a bare ``state_dict``, without
    BatchNorm's ``num_batches_tracked`` counters."""
    dev = next(model.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=False)
    sd = ckpt.get("state_dict", ckpt)
    model.load_state_dict({k: v for k, v in sd.items()
                           if not k.endswith("num_batches_tracked")})


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The path ``last_checkpoint`` in ``work_dir`` names, if it exists."""
    f = os.path.join(work_dir, LAST)
    if os.path.exists(f):
        with open(f) as fh:
            p = fh.read().strip()
        return p if os.path.exists(p) else None
    return None
