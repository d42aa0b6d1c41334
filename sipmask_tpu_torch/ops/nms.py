"""Exact single-class and multiclass hard NMS, soft-NMS and YOLACT's fast
NMS, the ports of ``sipmask_tpu/ops/nms.py:hard_nms``, ``soft_nms``,
``multiclass_nms_idx`` (its hard and soft paths) and ``fast_nms``.

Plain PyTorch: they are not Pallas kernels in the JAX package either. The
multiclass algorithms are the same wave-batched greedy over the full (N, C)
score matrix (see the JAX source for why each is exact); ``jax.lax.top_k``
becomes a stable descending sort, which keeps its lower-index-first order
among equal scores, and ``jnp.argmax`` is ``torch.argmax`` (the first
index of the maximum). The loop condition is read on the host once per
wave. :func:`hard_nms` works the greedy over the N x N IoU matrix instead,
one host read per round; :func:`soft_nms` runs its ``max_out`` steps on the
device without a host read.
"""

from __future__ import annotations

import torch

from ..core.boxes import bbox_overlaps, jaccard_nop1

NEG = -1.0e4


def _top(x, k: int):
    """``lax.top_k`` on the last axis: descending, ties lower index first."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def hard_nms(boxes, scores, iou_thr: float, max_out: int):
    """Greedy hard NMS with the +1 IoU, batched over leading dimensions:
    the JAX package's ``hard_nms`` (without its class_ids and plus1
    options) on each row.

    The greedy visits the candidates in the order of a stable descending
    sort (``jnp.argmax``'s: ties to the lower index) and keeps a candidate
    unless a kept one before it overlaps it by more than ``iou_thr``; a
    kept pick never suppresses itself, however degenerate. That keep set
    is the only fixed point of ``keep[t] = live[t] and no kept s < t
    overlaps t``, and iterating the rule from ``keep = live`` makes at
    least one more position final each round, so the loop ends in at most
    N rounds, each one read on the host (a few where few suppressions
    chain).

    Args:
      boxes: (..., N, 4); scores: (..., N), invalid candidates must carry a
        score <= NEG/2.
      max_out: number of greedy selections.
    Returns keep_idx (..., max_out) long (-1 when empty), keep_scores
    (NEG when empty) and valid, the picks in greedy order.
    """
    n = scores.shape[-1]
    s, order = _top(scores, n)
    b = torch.gather(boxes, -2, order[..., None].expand(boxes.shape))
    live = s > NEG / 2
    sup = torch.triu(bbox_overlaps(b, b) > iou_thr, diagonal=1)  # s < t
    keep = live
    for _ in range(n):
        new = live & ~(sup & keep[..., :, None]).any(-2)
        if torch.equal(new, keep):
            break
        keep = new
    pos = torch.arange(n, device=scores.device).expand(keep.shape)
    rank, at = torch.sort(torch.where(keep, pos, n), dim=-1)
    rank, at = rank[..., :max_out], at[..., :max_out]
    valid = rank < n
    if max_out > n:
        pad = (0, max_out - n)
        valid = torch.nn.functional.pad(valid, pad)
        at = torch.nn.functional.pad(at, pad)
    keep_idx = torch.where(valid, torch.gather(order, -1, at.clamp(max=n - 1)),
                           torch.full_like(at, -1))
    keep_scores = torch.where(valid, torch.gather(s, -1, at.clamp(max=n - 1)),
                              torch.full(at.shape, NEG, dtype=s.dtype,
                                         device=s.device))
    return keep_idx, keep_scores, valid


def _decay(ov, method: str, iou_thr: float, sigma: float):
    """Soft-NMS's score factor for IoU ``ov`` with the pick: exp(-IoU² /
    sigma) ('gaussian'), else 1 - IoU above ``iou_thr`` ('linear')."""
    if method == "gaussian":
        return torch.exp(-(ov * ov) / sigma)
    return torch.where(ov > iou_thr, 1.0 - ov, 1.0)


def soft_nms(boxes, scores, iou_thr: float = 0.3, max_out: int = 100,
             method: str = "linear", sigma: float = 0.5,
             min_score: float = 1e-3, class_ids=None):
    """Soft-NMS with the +1 IoU (the reference's soft_nms_cpu.cpp): greedy
    argmax selection for ``max_out`` steps; the scores of the other boxes
    decay by ``_decay`` of their IoU with each pick (within the pick's
    class when ``class_ids`` (N,) is given), and a box that falls below
    ``min_score`` is dropped, as is a box that starts at or below it.

    Args:
      boxes: (N, 4); scores: (N,).
    Returns keep_idx (max_out,) long (-1 when empty), keep_scores (NEG
    when empty) and valid, the picks in greedy order with their decayed
    scores.
    """
    n = boxes.shape[0]
    dev = scores.device
    at = torch.arange(n, device=dev)
    neg = torch.full_like(scores, NEG)
    live = torch.where(scores > min_score, scores, neg)
    keep_idx = torch.full((max_out,), -1, dtype=torch.long, device=dev)
    keep_scores = torch.full((max_out,), NEG, dtype=scores.dtype,
                             device=dev)
    for i in range(max_out):
        j = torch.argmax(live)
        s = live[j]
        picked = s > min_score
        keep_idx[i] = torch.where(picked, j, -1)
        keep_scores[i] = torch.where(picked, s, NEG)
        ov = bbox_overlaps(boxes[j][None], boxes)[0]
        if class_ids is not None:
            ov = torch.where(class_ids[j] == class_ids, ov,
                             torch.zeros_like(ov))
        live = torch.where(picked, live * _decay(ov, method, iou_thr, sigma),
                           live)
        live = torch.where((live < min_score) | (at == j), neg, live)
    return keep_idx, keep_scores, keep_scores > NEG / 2


def multiclass_nms_idx(boxes, scores, score_thr: float, iou_thr: float,
                       max_per_img: int, score_factors=None,
                       nms_type: str = "nms", soft_method: str = "linear",
                       soft_sigma: float = 0.5,
                       soft_min_score: float = 1e-3):
    """Per-class greedy NMS (+1 IoU), then the global top by score.

    Args:
      boxes: (N, 4) class-agnostic xyxy boxes.
      scores: (N, C) per-class sigmoid scores.
      score_factors: optional (N,), multiplied into the scores after the
        threshold on the raw score.
      nms_type: 'nms' (hard) or 'soft_nms' (per-class soft-NMS, ``soft_*``
        its method, sigma and min_score: :func:`soft_nms`).
    Returns dict, each of length max_per_img: boxes (., 4), scores, labels
    (0-based, -1 when empty), idxs (input row), valid.
    """
    n, c = scores.shape
    dev = scores.device
    eff = scores * score_factors[:, None] if score_factors is not None \
        else scores
    eff = torch.where(scores > score_thr, eff, torch.full_like(eff, NEG))
    if nms_type == "soft_nms":
        return _multiclass_soft_nms(boxes, eff, iou_thr, max_per_img,
                                    soft_method, soft_sigma, soft_min_score)
    if nms_type != "nms":
        raise ValueError(f"nms_type {nms_type!r}: 'nms' or 'soft_nms'")
    wave = max(1, min(8, max_per_img, n))
    width = max_per_img + wave   # per-class accept buffer
    live = eff.t().contiguous()                           # (C, N)
    acc_s = torch.full((c, width), NEG, dtype=eff.dtype, device=dev)
    acc_r = torch.zeros((c, width), dtype=torch.long, device=dev)
    cnt = torch.zeros((c,), dtype=torch.long, device=dev)

    for _ in range(max_per_img):
        # JAX's while_loop condition: stop once nothing is live, or once
        # max_per_img accepted picks score strictly above every live score
        rem = live.max()
        finalized = (acc_s > torch.clamp(rem, min=NEG / 2)).sum() \
            >= max_per_img
        if not bool((rem > NEG / 2) & ~finalized):
            break
        s_w, j_w = _top(live, wave)                       # (C, T)
        bw = boxes[j_w]                                   # (C, T, 4)
        iou_w = bbox_overlaps(bw, bw)                     # (C, T, T)
        # exact greedy inside the window
        acc = torch.zeros((c, wave), dtype=torch.bool, device=dev)
        acc[:, 0] = s_w[:, 0] > NEG / 2
        for t in range(1, wave):
            conflict = (acc[:, :t] & (iou_w[:, :t, t] > iou_thr)).any(1)
            acc[:, t] = (s_w[:, t] > NEG / 2) & ~conflict
        # suppress same-class overlaps of every accepted pick, and the picks
        # themselves (a degenerate box has zero +1-convention self-IoU)
        sup = ((bbox_overlaps(bw, boxes) > iou_thr) & acc[:, :, None]).any(1)
        live = live.masked_fill(sup, NEG)
        rows, ts = acc.nonzero(as_tuple=True)
        live[rows, j_w[rows, ts]] = live[rows, j_w[rows, ts]].clamp(max=NEG)
        # append the accepted picks of each class after its earlier ones
        pos = cnt[:, None] + torch.cumsum(acc, 1) - 1
        rows, ts = (acc & (pos < width)).nonzero(as_tuple=True)
        acc_s[rows, pos[rows, ts]] = s_w[rows, ts]
        acc_r[rows, pos[rows, ts]] = j_w[rows, ts]
        cnt = cnt + acc.sum(1)

    return _global_top(boxes, acc_s, acc_r, max_per_img)


def _global_top(boxes, acc_s, acc_r, max_per_img: int):
    """The global top ``max_per_img`` of the per-class accept buffers
    (scores ``acc_s`` and input rows ``acc_r``, (C, width))."""
    width = acc_s.shape[1]
    ks, flat = _top(acc_s.reshape(-1), max_per_img)
    kr = acc_r.reshape(-1)[flat]
    valid = ks > NEG / 2
    return dict(
        boxes=boxes[kr] * valid[:, None],
        scores=torch.where(valid, ks, torch.zeros_like(ks)),
        labels=torch.where(valid, flat // width, torch.full_like(flat, -1)),
        idxs=kr,
        valid=valid,
    )


def _multiclass_soft_nms(boxes, eff, iou_thr: float, max_per_img: int,
                         method: str, sigma: float, min_score: float):
    """Per-class sequential soft-NMS over the full (N, C) matrix of
    effective scores (NEG below the score threshold), then the global top
    ``max_per_img``: the JAX package's ``_multiclass_soft_nms``.

    Each wave takes every class's top ``wave`` live candidates and runs the
    sequential recurrence inside that window; the scores outside it are
    frozen at their values before the wave, which bound their true ones
    from above, so a pick whose decayed score strictly beats the window's
    lowest score before the wave is the class's true next pick, and a class
    stops its wave at the first pick that does not (the first pick of a
    wave is always exact). The wave's decay of the whole row, the product
    of its picks' factors, is applied at its end. A candidate below
    ``min_score`` is dropped up front (the JAX package's documented
    divergence from soft_nms_cpu.cpp). The loop condition is read on the
    host once a wave; the scatters of the picks a class does not accept go
    to one spare column, so a wave needs no other read.
    """
    n, c = eff.shape
    dev, f = eff.device, eff.dtype
    wave = max(1, min(8, max_per_img, n))
    width = max_per_img + wave   # per-class accept buffer
    rows = torch.arange(c, device=dev)
    slots = torch.arange(wave, device=dev)
    live = torch.where(eff >= min_score, eff,
                       torch.full_like(eff, NEG)).t().contiguous()  # (C, N)
    acc_s = torch.full((c, width + 1), NEG, dtype=f, device=dev)
    acc_r = torch.zeros((c, width + 1), dtype=torch.long, device=dev)
    cnt = torch.zeros((c,), dtype=torch.long, device=dev)
    neg_col = torch.full((c, 1), NEG, dtype=f, device=dev)

    for _ in range(max_per_img):
        # stop once nothing is live, or once max_per_img accepted picks
        # score strictly above every live score (scores only decay)
        rem = live.max()
        finalized = (acc_s[:, :width] > torch.clamp(rem, min=NEG / 2)
                     ).sum() >= max_per_img
        if not bool((rem > NEG / 2) & ~finalized):
            break
        s_w, j_w = _top(live, wave)                       # (C, T)
        out_bound = s_w[:, -1]
        bw = boxes[j_w]                                   # (C, T, 4)
        iou_w = bbox_overlaps(bw, bw)                     # (C, T, T)
        iou_full = bbox_overlaps(bw, boxes)               # (C, T, N)
        # the sequential recurrence inside the window
        cur = s_w
        stopped = torch.zeros((c,), dtype=torch.bool, device=dev)
        oks, pos_w, s_p = [], [], []
        for t in range(wave):
            p = torch.argmax(cur, 1)                      # window position
            sp = cur[rows, p]
            ok = ~stopped & (sp > NEG / 2)
            if t > 0:
                ok &= sp > out_bound
            stopped = ~ok
            oks.append(ok)
            pos_w.append(p)
            s_p.append(sp)
            okc = ok[:, None]
            cur = torch.where(
                okc, cur * _decay(iou_w[rows, p], method, iou_thr, sigma),
                cur)
            cur = torch.where(okc & ((cur < min_score)
                                     | (slots == p[:, None])), NEG, cur)
        acc = torch.stack(oks, 1)                         # step t accepted?
        pw = torch.stack(pos_w, 1)
        picked = torch.gather(j_w, 1, pw)                 # their input rows
        rec_s = torch.where(acc, torch.stack(s_p, 1), NEG)
        rec_r = torch.where(acc, picked, 0)
        pick_w = torch.where(acc, picked, n)
        # the wave's decay of the whole row: the accepted picks' factors,
        # multiplied in pick order (the JAX package's rounding)
        dec = torch.where(acc[:, :, None], _decay(torch.gather(
            iou_full, 1, pw[:, :, None].expand(c, wave, n)), method,
            iou_thr, sigma), 1.0)                         # (C, T, N)
        dec_full = dec[:, 0]
        for t in range(1, wave):
            dec_full = dec_full * dec[:, t]
        # the decay applies to live entries only (NEG times a factor would
        # rise above the validity threshold); the picks leave the row
        live = torch.where(live > NEG / 2, live * dec_full, NEG)
        live = torch.where(live < min_score, NEG, live)
        live = torch.cat([live, neg_col], 1).scatter_(1, pick_w, NEG)[:, :n]
        # append the accepted picks of each class after its earlier ones
        pos = cnt[:, None] + torch.cumsum(acc, 1) - 1
        cols = torch.where(acc & (pos < width), pos, width)
        acc_s.scatter_(1, cols, rec_s)
        acc_r.scatter_(1, cols, rec_r)
        cnt = cnt + acc.sum(1)

    return _global_top(boxes, acc_s[:, :width], acc_r[:, :width],
                       max_per_img)


def fast_nms(boxes, scores_cn, cofs, iou_thr: float = 0.5, top_k: int = 200,
             score_thr: float = 0.1, max_out: int = 100):
    """YOLACT-style matrix NMS (the reference's sipmask_head.py:868-910).

    Per class, the top ``top_k`` scores; a box is dropped when a
    higher-scored box of its class overlaps it by more than ``iou_thr``
    (no +1 IoU, ``jaccard_nop1``) or its score is at most ``score_thr``;
    then the global top ``max_out``. Both top-k's are stable sorts, so ties
    go lower index first as with ``jax.lax.top_k``.

    Args:
      boxes: (N, 4); scores_cn: (C, N) class-major scores (already times
        centerness at the call site); cofs: (N, D) payload gathered along.
    Returns dict, each of length max_out: boxes (., 4), scores, labels
    (0-based, -1 when empty), cofs (., D), idxs, valid.
    """
    c, n = scores_cn.shape
    k = min(top_k, n)
    scores_s, idx = _top(scores_cn, k)                    # (C, k)
    b = boxes[idx.reshape(-1)].reshape(c, k, 4)
    iou = torch.triu(jaccard_nop1(b, b), diagonal=1)      # (C, k, k)
    iou_max = iou.max(dim=1).values   # max IoU with a higher-scored box
    keep = (iou_max <= iou_thr) & (scores_s > score_thr)
    masked = torch.where(keep, scores_s,
                         torch.full_like(scores_s, NEG)).reshape(-1)
    out_scores, out_flat = _top(masked, max_out)
    picked = idx.reshape(-1)[out_flat]
    valid = out_scores > NEG / 2
    vf = valid[:, None].to(boxes.dtype)
    return dict(
        boxes=boxes[picked] * vf,
        scores=torch.where(valid, out_scores, torch.zeros_like(out_scores)),
        labels=torch.where(valid, out_flat // k, torch.full_like(out_flat,
                                                                 -1)),
        cofs=cofs[picked] * vf,
        idxs=torch.where(valid, picked, torch.zeros_like(picked)),
        valid=valid,
    )
