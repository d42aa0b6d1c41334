"""Batched, prefetching host data loaders with static-shape buckets, the
port of ``sipmask_tpu/data/loader.py`` (numpy batches, the caller moves
them to the device):

- aspect-ratio-grouped batches (landscape / portrait), so each batch pads
  to one of two static shapes (mmdet's GroupSampler);
- the RepeatDataset epoch multiplier via ``repeat_times``;
- transform workers and a bounded prefetch queue: threads sharing the
  transform's one rng by default (so ``num_workers=1`` draws exactly as the
  JAX package's loader does), or worker processes with
  ``num_worker_procs > 0``, each sample seeded from (seed, step, index);
- sharding of the index stream by (shard_id, num_shards), the
  DistributedGroupSampler analog;
- SipMask-VIS's frame-pair loader (``build_vis_train_loader``), whose
  worker processes also reseed the dataset's reference-frame draw.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
import numpy as np

from .transforms import TestTransform, TrainTransform

# --- process-pool worker plumbing (torch DataLoader worker analog).
# Spawn (not fork: the parent holds CUDA and loader threads) + one-time
# initargs. Randomness is seeded PER SAMPLE from (base seed, producer step,
# index): augmentation and the VIS reference-frame draw are then
# deterministic given the config seed and independent of worker count and
# scheduling, and the same image still gets fresh draws on every epoch
# revisit (the step moves).
_W_DATASET = None
_W_TRANSFORM = None
_W_SEED = 0


def _proc_init(dataset, transform, seed_base):
    global _W_DATASET, _W_TRANSFORM, _W_SEED
    _W_DATASET = dataset
    _W_TRANSFORM = transform
    _W_SEED = seed_base


def _sample_rng(step, idx, salt=0):
    ss = np.random.SeedSequence((_W_SEED, step, int(idx), salt))
    return np.random.RandomState(ss.generate_state(1)[0])


def _proc_load_train(args):
    idx, step = args
    if hasattr(_W_TRANSFORM, "rng"):
        _W_TRANSFORM.rng = _sample_rng(step, idx)
    img = _W_DATASET.load_image(int(idx))
    boxes, labels, masks = _W_DATASET.get_ann(int(idx))
    return _W_TRANSFORM(img, boxes, labels, masks,
                        image_id=_W_DATASET.image_id(int(idx)))


def _proc_load_pair(args):
    idx, step = args
    if hasattr(_W_TRANSFORM, "rng"):
        _W_TRANSFORM.rng = _sample_rng(step, idx)
    if hasattr(_W_DATASET, "rng"):   # the reference-frame draw
        _W_DATASET.rng = _sample_rng(step, idx, salt=1)
    return _W_TRANSFORM(_W_DATASET.get_train_pair(int(idx)))


def _make_mapper(dataset, transform, num_workers, num_worker_procs,
                 load_one, proc_load=_proc_load_train, seed=0):
    """Returns (mapper(idxs, step), shutdown) backed by threads or
    processes. The thread path shares the transform's single rng (order
    nondeterministic under concurrency either way); the process path uses
    the per-sample seeding above."""
    if num_worker_procs > 0:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor
        pool = ProcessPoolExecutor(
            num_worker_procs, mp_context=mp.get_context("spawn"),
            initializer=_proc_init, initargs=(dataset, transform, seed))
        return (lambda idxs, step: pool.map(
            proc_load, [(int(i), step) for i in idxs]),
            lambda: pool.shutdown(wait=False, cancel_futures=True))
    pool = ThreadPoolExecutor(num_workers)
    return (lambda idxs, step: pool.map(load_one, idxs),
            lambda: pool.shutdown(wait=False))


class _ProducerError:
    """Carries a producer-thread exception through the prefetch queue so
    training fails loudly instead of hanging at q.get() (e.g. a worker
    killed by the OOM killer -> BrokenProcessPool, or unpicklable state
    under the spawn context)."""

    def __init__(self, exc):
        self.exc = exc


def _put_until(q, item, stop):
    """q.put that gives up once the consumer generator is closed."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


def _stack_batch(samples, keys=("image", "gt_bboxes", "gt_labels",
                                "gt_masks", "img_shape", "scale_factor")):
    name_map = dict(image="images", img_shape="img_shapes",
                    scale_factor="scale_factors")
    out = {}
    for k in keys:
        v = np.stack([getattr(s, k) for s in samples])
        out[name_map.get(k, k)] = v
    out["image_ids"] = np.asarray([s.image_id for s in samples])
    out["ori_shapes"] = np.asarray([s.ori_shape for s in samples])
    return out


def _grouped_loader(dataset, batch_size, seed, repeat_times, mapper,
                    shutdown, stack, prefetch, shard_id, num_shards):
    """The infinite aspect-grouped iterator behind the train loaders: a
    producer thread maps each epoch's batches of indices through
    ``mapper`` and queues ``stack(samples)``. Returns (iterator,
    steps_per_epoch)."""
    rng = np.random.RandomState(seed)
    flags = np.asarray([dataset.aspect_flag(i) for i in range(len(dataset))])
    groups = [np.where(flags)[0], np.where(~flags)[0]]
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def epoch_batches():
        batches = []
        for g in groups:
            if not len(g):
                continue
            idx = np.concatenate([rng.permutation(g)
                                  for _ in range(repeat_times)])
            # round up to full batches by wrapping (GroupSampler behavior)
            n = int(np.ceil(len(idx) / batch_size)) * batch_size
            idx = np.concatenate([idx, idx[:n - len(idx)]])
            batches.extend(idx.reshape(-1, batch_size))
        order = rng.permutation(len(batches))
        return [batches[i] for i in order][shard_id::num_shards]

    stop = threading.Event()

    def producer():
        step = 0
        try:
            while not stop.is_set():
                for bidx in epoch_batches():
                    samples = list(mapper(bidx, step))
                    if not _put_until(q, stack(samples), stop):
                        return
                    step += 1
        except BaseException as e:  # propagate to the consumer
            _put_until(q, _ProducerError(e), stop)

    threading.Thread(target=producer, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:
            stop.set()
            shutdown()

    steps_per_epoch = sum(
        int(np.ceil(len(g) * repeat_times / batch_size)) for g in groups
        if len(g)) // max(num_shards, 1)
    return gen(), steps_per_epoch


def build_train_loader(dataset, transform: TrainTransform, batch_size: int,
                       seed: int = 0, repeat_times: int = 1,
                       num_workers: int = 8, prefetch: int = 4,
                       shard_id: int = 0, num_shards: int = 1,
                       num_worker_procs: int = 0):
    """Infinite iterator of stacked numpy batches, aspect-grouped; returns
    (iterator, steps_per_epoch)."""
    def load_one(idx):
        img = dataset.load_image(idx)
        boxes, labels, masks = dataset.get_ann(idx)
        return transform(img, boxes, labels, masks,
                         image_id=dataset.image_id(idx))

    mapper, shutdown = _make_mapper(dataset, transform, num_workers,
                                    num_worker_procs, load_one, seed=seed)
    return _grouped_loader(dataset, batch_size, seed, repeat_times, mapper,
                           shutdown, _stack_batch, prefetch, shard_id,
                           num_shards)


def build_test_loader(dataset, transform: TestTransform, batch_size: int = 1,
                      num_workers: int = 8,
                      shard_id: int = 0, num_shards: int = 1):
    """Finite iterator over the dataset in aspect-grouped static batches.

    Yields (batch_dict, n_valid) where the last batch of each group is
    padded by repeating its final sample (results beyond n_valid dropped).
    """
    flags = np.asarray([dataset.aspect_flag(i) for i in range(len(dataset))])
    groups = [np.where(flags)[0], np.where(~flags)[0]]
    pool = ThreadPoolExecutor(num_workers)

    def load_one(idx):
        return transform(dataset.load_image(idx),
                         image_id=dataset.image_id(idx))

    def gen():
        for g in groups:
            g = g[shard_id::num_shards]
            for i in range(0, len(g), batch_size):
                chunk = list(g[i:i + batch_size])
                n_valid = len(chunk)
                while len(chunk) < batch_size:
                    chunk.append(chunk[-1])
                samples = list(pool.map(load_one, chunk))
                yield _stack_batch(samples), n_valid

    return gen()


_PAIR_NAMES = dict(image="images", ref_image="ref_images",
                   img_shape="img_shapes", scale_factor="scale_factors")


def _stack_pairs(samples):
    return {_PAIR_NAMES.get(k, k): np.stack([s[k] for s in samples])
            for k in samples[0]}


def build_vis_train_loader(dataset, transform, batch_size: int,
                           seed: int = 0, num_workers: int = 8,
                           prefetch: int = 4, shard_id: int = 0,
                           num_shards: int = 1, num_worker_procs: int = 0):
    """SipMask-VIS's infinite iterator of aspect-grouped batches of frame
    pairs (a ``YTVOSDataset`` through a ``VISPairTransform``): dicts of
    images, ref_images, gt_bboxes, gt_labels, gt_masks, gt_pids,
    ref_bboxes_jit, ref_labels, img_shapes and scale_factors. Returns
    (iterator, steps_per_epoch)."""
    mapper, shutdown = _make_mapper(
        dataset, transform, num_workers, num_worker_procs,
        lambda idx: transform(dataset.get_train_pair(idx)), _proc_load_pair,
        seed=seed)
    return _grouped_loader(dataset, batch_size, seed, 1, mapper, shutdown,
                           _stack_pairs, prefetch, shard_id, num_shards)
