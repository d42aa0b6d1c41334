"""The train step, the port of ``sipmask_tpu/train/step.py``: forward,
``compute_losses`` (with SipMask++'s rescoring head, whose ``loss_iou``
joins the sum; with SipMask-VIS's reference frames, whose ``loss_match``
joins it and ``match_acc`` does not), backward of the summed ``loss*``
terms, the gradient clip when the config sets one, then the SGD update
with the scheduled lr.

Under a process group each rank runs the step on its shard of the global
batch. Its losses are already divided by the global batch's normalisers,
so the global loss's gradient is the sum of the ranks' gradients, not
their mean: one all-reduce sums them, with the losses riding in the same
buffer, before the clip (which then sees the global norm) and the update.
The metrics are the global batch's on every rank.
"""

from __future__ import annotations

from ..models.loss import compute_losses
from ..parallel import all_reduce_sum_
from ..utils.trace import span
from .optim import clip_gradients, set_lr
from .state import TrainState


def make_train_step(state: TrainState, cfg):
    """``train_step(batch) -> metrics``.

    batch: dict of tensors on the model's device, images (B, 3, H, W)
    normalized and padded, gt_bboxes, gt_labels, gt_masks (see
    ``compute_losses``); under a process group, this rank's shard of the
    global batch. The metrics are 0-d tensors on the device (each loss,
    and loss_total): the step reads nothing back to the host.
    """
    head_cfg = cfg.model.head
    clip = cfg.train.optim.grad_clip
    params = [p for g in state.optimizer.param_groups for p in g["params"]]

    def train_step(batch):
        with span("sipmask.step.forward"):
            out = state.model(batch["images"], batch["ref_images"]
                              if head_cfg.track else None)
        with span("sipmask.step.loss"):
            losses = compute_losses(
                out, batch, head_cfg, max_pos=cfg.train.max_pos,
                rescore_fn=state.model.rescore if head_cfg.rescoring
                else None)
            total = sum(v for k, v in losses.items() if k.startswith("loss"))
        with span("sipmask.step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            total.backward()
        with span("sipmask.step.update"):
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics["loss_total"] = total.detach()
            summed = [k for k in metrics if k.startswith("loss")]
            metrics.update(zip(summed, all_reduce_sum_(
                params, [metrics[k] for k in summed])))
            if clip is not None:
                clip_gradients(state.optimizer, clip)
            set_lr(state.optimizer, state.schedule(state.step))
            state.optimizer.step()
            state.step += 1
        return metrics

    return train_step
