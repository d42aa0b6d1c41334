"""Train state, the port of ``sipmask_tpu/train/state.py``: the model, its
optimizer, the schedule and the step count."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models.detector import SipMask, build_model
from ..utils.convert import init_weights
from .optim import lr_schedule, make_optimizer


@dataclass
class TrainState:
    model: SipMask
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    step: int = 0


def create_train_state(cfg, device="cuda", seed: int = 0,
                       steps_per_epoch: int = 1000,
                       state_dict=None) -> TrainState:
    """Build the model with the reference's random init from ``seed`` (or
    load ``state_dict``), move it to ``device``, and make its optimizer.

    cfg: a ``SipMaskConfig`` (``sipmask_tpu_torch.config``); SipMask++'s
    rescoring layers are built, initialised and trained with the rest."""
    model = build_model(cfg.model)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    model = model.to(device).train()
    optimizer = make_optimizer(cfg.train.optim, model)
    return TrainState(model, optimizer,
                      lr_schedule(cfg.train.optim, steps_per_epoch))
