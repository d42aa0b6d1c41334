"""The train step, the port of ``sipmask_tpu/train/step.py``: forward,
``compute_losses`` (with SipMask++'s rescoring head, whose ``loss_iou``
joins the sum; with SipMask-VIS's reference frames, whose ``loss_match``
joins it and ``match_acc`` does not), backward of the summed ``loss*``
terms, the gradient clip when the config sets one, then the SGD update
with the scheduled lr."""

from __future__ import annotations

from ..models.loss import compute_losses
from .optim import clip_gradients, set_lr
from .state import TrainState


def make_train_step(state: TrainState, cfg):
    """``train_step(batch) -> metrics``.

    batch: dict of tensors on the model's device, images (B, 3, H, W)
    normalized and padded, gt_bboxes, gt_labels, gt_masks (see
    ``compute_losses``). The metrics are 0-d tensors on the device (each
    loss, and loss_total): the step reads nothing back to the host.
    """
    head_cfg = cfg.model.head
    clip = cfg.train.optim.grad_clip

    def train_step(batch):
        set_lr(state.optimizer, state.schedule(state.step))
        out = state.model(batch["images"], batch["ref_images"]
                          if head_cfg.track else None)
        losses = compute_losses(
            out, batch, head_cfg, max_pos=cfg.train.max_pos,
            rescore_fn=state.model.rescore if head_cfg.rescoring else None)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        if clip is not None:
            clip_gradients(state.optimizer, clip)
        state.optimizer.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["loss_total"] = total.detach()
        return metrics

    return train_step
