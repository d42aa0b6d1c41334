"""Training driver, the port of ``sipmask_tpu/apis/train.py`` (the mmcv
Runner / benchmark ``do_train`` equivalent): an epoch loop over the
aspect-grouped loader around ``make_train_step``, smoothed metric logs
every ``log_interval`` steps, a checkpoint each
``checkpoint_interval_epochs`` and at the last step, auto-resume from
``work_dir``, ``load_from``, and an optional eval hook that keeps the best
checkpoint's record. A tracking preset (SipMask-VIS, ``head.track``)
trains on frame pairs of a YouTube-VIS-format set.

Under a process group (``sipmask_tpu_torch.parallel.init_distributed``)
each rank loads its shard of the batches (``imgs_per_device`` images a
rank: the global batch is that times the world size) and the step sums the
ranks' gradients; rank 0 logs and writes the checkpoints, the COCO eval
hook infers on every rank's shard and scores on rank 0, and the VIS hook
tracks and scores on rank 0 while the others wait.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch

from ..data.coco import CocoDataset
from ..data.loader import build_train_loader, build_vis_train_loader
from ..data.transforms import TrainTransform, VISPairTransform
from ..data.ytvos import YTVOSDataset
from ..parallel import barrier, process_shard_args
from ..train import create_train_state, make_train_step
from ..utils.checkpoint import (latest_checkpoint, load_weights,
                                restore_checkpoint, save_checkpoint)
from ..utils.demo_inputs import batch_to_tensors
from ..utils.logging import MetricLogger
from .inference import Detector


def make_coco_eval_hook(cfg, ann_file: str, img_prefix: str,
                        batch_size: int = 4, interval_epochs: int = 1,
                        metrics=("bbox", "segm")):
    """Eval during training (the reference's EvalHook): every
    ``interval_epochs``, COCO inference over ``ann_file`` with the model in
    eval mode, then ``evaluate_coco``. ``hook(state, epoch)`` returns the
    stats, or None between intervals. Under a process group each rank
    infers its shard, every rank collects the results, and rank 0 scores
    them (the others return None)."""
    from .test import evaluate_coco, run_inference

    dataset = CocoDataset(ann_file, img_prefix, test_mode=True)

    def hook(state, epoch):
        if epoch % interval_epochs:
            return None
        model = state.model
        device = next(model.parameters()).device
        model.eval()
        try:
            results = run_inference(Detector(cfg, model, device), dataset,
                                    batch_size=batch_size, progress=False,
                                    distributed=process_shard_args()[1] > 1)
        finally:
            model.train()
        if process_shard_args()[0] != 0:
            return None
        print(f"== eval @ epoch {epoch} ==")
        return evaluate_coco(results, ann_file, metrics=metrics)

    return hook


def make_ytvos_eval_hook(cfg, ann_file: str, img_prefix: str,
                         interval_epochs: int = 1):
    """SipMask-VIS's eval during training: every ``interval_epochs``,
    ``run_video_inference`` over ``ann_file``'s videos with the model in
    eval mode, then ``YTVOSEvaluator`` (the set needs annotations).
    ``hook(state, epoch)`` returns {"segm": track-level mask AP stats}, or
    None between intervals. Under a process group rank 0 tracks and scores
    the whole set while the other ranks wait for it at a barrier of the
    host group, whose timeout covers an evaluation; they return None."""
    from ..eval.ytvos_eval import YTVOSEvaluator
    from .test_video import run_video_inference

    dataset = YTVOSDataset(ann_file, img_prefix, test_mode=True)

    def hook(state, epoch):
        if epoch % interval_epochs:
            return None
        if process_shard_args()[0] != 0:
            barrier()
            return None
        model = state.model
        model.eval()
        try:
            results = run_video_inference(
                Detector(cfg, model, next(model.parameters()).device),
                dataset, progress=False)
            print(f"== VIS eval @ epoch {epoch} ==")
            ev = YTVOSEvaluator(ann_file)
            ev.update(results)
            stats = {"segm": ev.summarize()}
        finally:
            model.train()
            barrier()
        return stats

    return hook


def train_detector(cfg, ann_file: str, img_prefix: str, work_dir: str,
                   resume: bool = True, load_from: Optional[str] = None,
                   max_steps: Optional[int] = None,
                   eval_hook: Optional[Callable] = None, dataset=None,
                   device="cuda"):
    """Train ``cfg`` (a ``SipMaskConfig``) on a COCO-format set, or on a
    YouTube-VIS-format one when the head tracks; returns the final
    ``TrainState``.

    The weights start from the config's random init (seed
    ``cfg.train.seed``), then ``load_from`` (weights only), then, with
    ``resume``, the checkpoint ``work_dir/last_checkpoint`` names (weights,
    SGD state and step, so the lr schedule resumes too). The loader's
    position is not part of a checkpoint: a resumed run starts a fresh
    loader from ``cfg.train.seed``, as the JAX package's driver does.
    Each step's next batch is fetched and sent to the device while the
    step runs; the step's losses stay on the device until the next log or
    checkpoint, which reads them back in one transfer.

    Under a process group ``device`` is this rank's
    (``parallel.rank_device``), every rank starts from the same weights
    (the same seed, ``load_from`` and checkpoint), loads every world-th
    batch of each epoch's shuffled batches (steps_per_epoch is that
    shard's), and runs the same number of steps.
    """
    os.makedirs(work_dir, exist_ok=True)
    seed, d = cfg.train.seed, cfg.data
    rank, world = process_shard_args()
    if cfg.model.head.track:   # SipMask-VIS: current + reference frames
        if dataset is None:
            dataset = YTVOSDataset(ann_file, img_prefix, seed=seed)
        loader, steps_per_epoch = build_vis_train_loader(
            dataset, VISPairTransform(d, seed=seed),
            cfg.train.imgs_per_device, seed=seed, shard_id=rank,
            num_shards=world, num_workers=d.num_workers,
            num_worker_procs=d.num_worker_procs)
    else:
        if dataset is None:
            dataset = CocoDataset(ann_file, img_prefix)
        loader, steps_per_epoch = build_train_loader(
            dataset, TrainTransform(d, seed=seed), cfg.train.imgs_per_device,
            seed=seed, repeat_times=d.repeat_times, shard_id=rank,
            num_shards=world, num_workers=d.num_workers,
            num_worker_procs=d.num_worker_procs)
    if steps_per_epoch < 1:
        raise ValueError(f"{len(dataset)} images make fewer batches of "
                         f"{cfg.train.imgs_per_device} than the {world} ranks")
    state = create_train_state(cfg, device, seed=seed,
                               steps_per_epoch=steps_per_epoch)
    if load_from:
        load_weights(load_from, state.model)
        print(f"loaded weights from {load_from}")
    if resume:
        last = latest_checkpoint(work_dir)
        if last:
            restore_checkpoint(last, state)
            print(f"resumed from {last} at step {state.step}")

    step_fn = make_train_step(state, cfg)
    logger = MetricLogger(log_file=os.path.join(work_dir, "train.log.json"))
    total_steps = steps_per_epoch * cfg.train.optim.total_epochs
    if max_steps is not None:
        total_steps = min(total_steps, max_steps)
    ckpt_every = steps_per_epoch * cfg.train.checkpoint_interval_epochs
    best_score = -1.0
    pending = []

    def flush_metrics():
        """All buffered step metrics to the host in one stacked copy."""
        if not pending:
            return
        keys = list(pending[0])
        rows = torch.stack([torch.stack([m[k] for k in keys])
                            for m in pending]).cpu().tolist()
        for row in rows:
            logger.update(**dict(zip(keys, row)))
        pending.clear()

    try:
        batch = batch_to_tensors(next(loader), device)
        while state.step < total_steps:
            pending.append(step_fn(batch))
            if state.step < total_steps:   # overlaps the device step
                batch = batch_to_tensors(next(loader), device)
            step = state.step
            if step % cfg.train.log_interval == 0:
                flush_metrics()
                logger.log(step, total_steps, lr=state.schedule(step))
            if step % ckpt_every and step != total_steps:
                continue
            flush_metrics()
            epoch = step // steps_per_epoch
            path = os.path.join(work_dir, f"epoch_{epoch}.pth")
            # meta: the config and class names, as the reference's
            save_checkpoint(path, state, meta=dict(
                config=cfg.name, step=step,
                config_dict=dataclasses.asdict(cfg),
                classes=list(getattr(dataset, "CLASSES", []))))
            print(f"saved checkpoint {path}")
            if eval_hook is None:
                continue
            stats = eval_hook(state, epoch)
            if stats:
                logger.log_record(step=step, epoch=epoch, **{
                    f"val/{it}/{k}": v for it, s in stats.items()
                    for k, v in s.items()})
                key = "segm" if "segm" in stats else "bbox"
                score = stats[key]["AP"]
                if score > best_score:
                    best_score = score
                    with open(os.path.join(work_dir, "best_checkpoint"),
                              "w") as f:
                        f.write(f"{path}\n{key}/AP={score:.4f}\n")
                    print(f"new best {key}/AP {score:.4f} -> {path}")
    finally:
        loader.close()
    return state
