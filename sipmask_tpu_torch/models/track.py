"""SipMask-VIS tracking, the port of ``sipmask_tpu/models/track.py``: the
match loss of training and the streaming tracker of video inference.

- ``extract_center_feats``: the embedding at floor(box centre / 8),
  clipped to the grid (NCHW: ``track_feats[:, cy, cx]``).
- ``track_match_loss``: each selected positive of the current frame
  against the reference frame's (jittered) gts: logits cur @ ref^T, -1e4
  where the reference gt is padding, a zero "new object" column in front,
  a cross-entropy against ``gt_pids`` averaged over the valid selections;
  ``match_acc`` is a metric only.
- ``TrackerState`` / ``tracker_step``: the fixed-capacity tracker. Each
  detection scores log_softmax(match) + log(score) + 2 IoU + 10 same-label
  against the memory as it was before the frame, then the detections are
  assigned one after another (the JAX package's ``fori_loop``): a new
  object takes the first free slot, else evicts the least recently seen
  slot that no valid detection of this frame matched; a matched object
  keeps its first label and the best-scoring of its detections; object ids
  are issued in order and never reused; ``overflow`` counts evictions.

The state lives on the detections' device and the loop is tensor ops only:
a frame reads nothing back to the host; the caller reads the object ids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.boxes import bbox_overlaps
from ..parallel import global_sum, process_shard_args

NEG = -1.0e4
FAR_FUTURE = 2 ** 30   # an eviction key no slot reaches


def _center_index(boxes, h: int, w: int, stride: int):
    """Flat (cy * w + cx) grid index of each box's centre, boxes (..., 4)
    in input coordinates."""
    cx = torch.floor((boxes[..., 0] + boxes[..., 2]) / 2.0 / stride).long()
    cy = torch.floor((boxes[..., 1] + boxes[..., 3]) / 2.0 / stride).long()
    return cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)


def extract_center_feats(track_feats, boxes, stride: int = 8):
    """track_feats (C, Hf, Wf); boxes (N, 4) in input coordinates ->
    (N, C)."""
    c, h, w = track_feats.shape
    idx = _center_index(boxes, h, w, stride)
    return track_feats.reshape(c, h * w)[:, idx].t()


def _center_feats_batched(track_feats, boxes, stride: int = 8):
    """track_feats (B, C, Hf, Wf); boxes (B, N, 4) -> (B, N, C)."""
    b, c, h, w = track_feats.shape
    idx = _center_index(boxes, h, w, stride)                 # (B, N)
    flat = track_feats.reshape(b, c, h * w)
    return torch.gather(flat, 2, idx[:, None, :].expand(b, c, idx.shape[1])
                        ).transpose(1, 2)


def jitter_boxes(boxes, generator: torch.Generator,
                 amplitude: float = 0.05):
    """The reference frame's gt box jitter (centre and size moved by up to
    ``amplitude`` of the size), drawing from ``generator`` (on the boxes'
    device)."""
    off = (torch.rand((boxes.shape[0], 4), generator=generator,
                      device=boxes.device) * 2 - 1) * amplitude
    cxcy = (boxes[:, 2:4] + boxes[:, :2]) / 2
    wh = (boxes[:, 2:4] - boxes[:, :2]).abs()
    new_cxcy = cxcy + wh * off[:, :2]
    new_wh = wh * (1 + off[:, 2:])
    return torch.cat([new_cxcy - new_wh / 2, new_cxcy + new_wh / 2], 1)


def _match_ce(track_feats, track_feats_ref, box_sel, sel_valid, gtidx_sel,
              gt_pids, ref_boxes, ref_valid):
    """Per-image match CE, batched: (ce_mean (B,), acc (B,), n_valid
    (B,)). In the embeddings' dtype, as JAX computes it: in bf16 the
    product is a bf16 matmul, NEG rounds to -9984, log_softmax runs on the
    bf16 logits, and ``ce * vf`` promotes to f32."""
    cur = _center_feats_batched(track_feats, box_sel * 2.0)     # (B, K, C)
    ref = _center_feats_batched(track_feats_ref, ref_boxes)     # (B, G, C)
    prod = torch.bmm(cur, ref.transpose(1, 2))                  # (B, K, G)
    prod = torch.where(ref_valid[:, None, :], prod,
                       torch.full_like(prod, NEG))
    logits = torch.cat([torch.zeros_like(prod[..., :1]), prod], 2)
    targets = torch.gather(gt_pids.long(), 1, gtidx_sel.long())  # (B, K)
    logp = torch.log_softmax(logits, 2)
    ce = -torch.gather(logp, 2, targets[..., None])[..., 0]
    vf = sel_valid.float()
    n = vf.sum(1).clamp(min=1.0)
    ce_mean = (ce * vf).sum(1) / n
    acc = ((logits.argmax(2) == targets).float() * vf).sum(1) / n
    return ce_mean, acc, vf.sum(1)


def track_match_loss_single(track_feats, track_feats_ref, box_sel,
                            sel_valid, gtidx_sel, gt_pids, ref_boxes,
                            ref_valid):
    """One image: track_feats / track_feats_ref (C, Hf, Wf); box_sel (K, 4)
    selected positive boxes in mask (stride-2) coordinates; sel_valid (K,);
    gtidx_sel (K,) their gt rows; gt_pids (G,) 1-based index into the
    reference gts, 0 = no match; ref_boxes (G, 4) in input coordinates;
    ref_valid (G,). Returns (ce_mean, acc, n_valid)."""
    ce, acc, n = _match_ce(track_feats[None], track_feats_ref[None],
                           box_sel[None], sel_valid[None], gtidx_sel[None],
                           gt_pids[None], ref_boxes[None], ref_valid[None])
    return ce[0], acc[0], n[0]


def track_match_loss(outputs, batch, box_sel, sel_valid, gtidx_sel):
    """The batch's match loss and accuracy from the loss's positive
    selection (box_sel, sel_valid, gtidx_sel: (B, K, ...)). batch needs
    ref_bboxes_jit (B, G, 4) in input coordinates, ref_labels (B, G) and
    gt_pids (B, G). Returns (loss_match, match_acc)."""
    ce, acc, n = _match_ce(
        outputs["track_feats"], outputs["track_feats_ref"],
        box_sel, sel_valid, gtidx_sel, batch["gt_pids"],
        batch["ref_bboxes_jit"].float(), batch["ref_labels"] > 0)
    # under a process group: the global batch's image count and accuracy
    hits, count = global_sum((acc * n).sum(), n.sum())
    loss_match = ce.sum() / (ce.shape[0] * process_shard_args()[1])
    match_acc = hits / count.clamp(min=1.0)
    return loss_match, match_acc


# --------------------------------------------------------------- inference

class TrackerState(NamedTuple):
    feats: torch.Tensor      # (M, 512)
    boxes: torch.Tensor      # (M, 5) xyxy + score, original coordinates
    labels: torch.Tensor     # (M,) int64
    active: torch.Tensor     # (M,) bool occupancy
    count: torch.Tensor      # () int64, object ids issued
    ids: torch.Tensor        # (M,) int64, the object id of each slot
    last_seen: torch.Tensor  # (M,) int64, the frame of each slot's write
    frame: torch.Tensor      # () int64, frames processed
    overflow: torch.Tensor   # () int64, evictions (capacity exceeded)


def tracker_init(max_tracks: int, feat_dim: int = 512,
                 device="cpu") -> TrackerState:
    def full(shape, v, dtype=torch.int64):
        return torch.full(shape, v, dtype=dtype, device=device)
    return TrackerState(
        feats=torch.zeros((max_tracks, feat_dim), device=device),
        boxes=torch.zeros((max_tracks, 5), device=device),
        labels=full((max_tracks,), -1),
        active=torch.zeros((max_tracks,), dtype=torch.bool, device=device),
        count=full((), 0), ids=full((max_tracks,), -1),
        last_seen=full((max_tracks,), -1), frame=full((), 0),
        overflow=full((), 0))


def tracker_step(state: TrackerState, det_boxes, det_scores, det_labels,
                 det_valid, det_feats, is_first,
                 match_coeff=(1.0, 2.0, 10.0)):
    """One frame. det_boxes (D, 4) in original coordinates, det_scores
    (D,), det_labels (D,), det_valid (D,) bool, det_feats (D, 512) the
    embeddings at the boxes' centres in input coordinates; is_first: a bool
    (or a 0-d bool tensor). Returns (new state, object ids (D,) int64, -1
    for a detection that was not written)."""
    dev = det_feats.device
    m, d = state.feats.shape[0], det_boxes.shape[0]
    fresh = torch.as_tensor(is_first, device=dev) | (state.count == 0)
    det_labels = det_labels.long()

    # scores against the memory before the frame; bf16 embeddings (the
    # bf16 graph) meet the f32 memory as JAX's promotion meets them: the
    # product of their f32 upcasts, in f32
    prod = det_feats.float() @ state.feats.t()               # (D, M)
    col = torch.zeros((d, 1), device=dev)
    match_score = torch.cat([col, torch.where(
        state.active[None, :], prod, torch.full_like(prod, NEG))], 1)
    label_delta = torch.cat([col + 1, (state.labels[None, :] ==
                                       det_labels[:, None]).float()], 1)
    ious = torch.cat([col, bbox_overlaps(det_boxes.float(),
                                         state.boxes[:, :4])], 1)
    comp = (torch.log_softmax(match_score, 1)
            + match_coeff[0] * torch.log(det_scores.float().clamp(
                min=1e-12))[:, None]
            + match_coeff[1] * ious + match_coeff[2] * label_delta)
    keep = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                      state.active])
    comp = torch.where(keep[None, :], comp, torch.full_like(comp, NEG))
    match_vals, match_ids = comp.max(1)      # ties: the first index
    slot_of = (match_ids - 1).clamp(0, m - 1)

    # slots matched by any valid detection of this frame are not evicted:
    # their matches were scored against the memory before the frame
    matched = (det_valid & (match_ids > 0) & ~fresh).long()
    protected = torch.zeros((m,), dtype=torch.int64, device=dev
                            ).scatter_reduce(0, slot_of, matched, "amax") > 0

    feats, boxes = state.feats.clone(), state.boxes.clone()
    labels, active = state.labels.clone(), state.active.clone()
    ids, last_seen = state.ids.clone(), state.last_seen.clone()
    count, overflow = state.count.clone(), state.overflow.clone()
    best = torch.full((m,), -100.0, device=dev)
    obj_ids = torch.full((d,), -1, dtype=torch.int64, device=dev)
    far = torch.full((m,), FAR_FUTURE, dtype=torch.int64, device=dev)
    boxes5 = torch.cat([det_boxes.float(), det_scores.float()[:, None]], 1)
    for i in range(d):
        valid, mid = det_valid[i], match_ids[i]
        is_new = fresh | (mid == 0)
        # a new object's slot: the first free one, else the least recently
        # seen unprotected one (all protected: plain LRU)
        any_free = ~active.all()
        first_free = torch.argmin(active.long())
        evict_key = torch.where(active & ~protected, last_seen, far)
        slot_new = torch.where(any_free, first_free,
                               torch.argmin(evict_key))
        mslot = slot_of[i:i + 1]
        obj = torch.where(is_new, slot_new, slot_of[i]).view(1)
        better = ~is_new & (match_vals[i] > best[mslot][0])
        write = valid & (is_new | better)
        new_id = count
        old_id = ids[obj][0]
        obj_ids[i] = torch.where(write, torch.where(is_new, new_id, old_id),
                                 -1)
        feats.index_copy_(0, obj, torch.where(
            write, det_feats[i:i + 1].float(), feats[obj]))
        boxes.index_copy_(0, obj, torch.where(write, boxes5[i:i + 1],
                                              boxes[obj]))
        # a matched object keeps its first label, as the reference never
        # updates its previous labels
        born = write & is_new
        labels.index_copy_(0, obj, torch.where(born, det_labels[i:i + 1],
                                               labels[obj]))
        active.index_copy_(0, obj, active[obj] | write)
        ids.index_copy_(0, obj, torch.where(born, new_id, old_id).view(1))
        last_seen.index_copy_(0, obj, torch.where(write, state.frame,
                                                  last_seen[obj]))
        count = count + (valid & is_new).long()
        overflow = overflow + (valid & is_new & ~any_free).long()
        best.index_copy_(0, mslot, torch.where(better & valid,
                                               match_vals[i:i + 1],
                                               best[mslot]))
    new_state = TrackerState(feats, boxes, labels, active, count, ids,
                             last_seen, state.frame + 1, overflow)
    return new_state, obj_ids
