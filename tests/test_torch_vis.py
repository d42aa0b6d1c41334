"""SipMask-VIS in the port (sipmask_tpu_torch) against the JAX package, f32
on the CPU: the track branch (current and reference frame) and the weight
bridge, the initialisation, extract_center_feats and the match loss on
fixed selections, tracker_step on the sequences of tests/test_vis.py and on
a random stream, compute_losses with loss_match, whole-model gradients and
a 2-step SGD trajectory with both frames, and run_video_inference on a tiny
PNG video set. The model cases run the VIS preset shrunk (FPN and head 32
wide, its own stacked_convs 3, sipmask_track 512 wide as the JAX head fixes
it; videos at 128x160); one JAX compile per case, shared through module
fixtures. The training cases run at 256x320, as tests/test_torch_train.py
does: at 128x160 a GroupNorm group of the P6/P7 towers (32 channels in 32
groups) holds 1-2 pixels, whose gradient is all rounding (the FPN's P6 and
P7 convs then differ by their whole size). Their head's ReLUs are pinned in
both packages to the sign masks of one float64 forward: VIS's
2-conv cls tower puts ~1e5 pre-activations behind the deformable conv, and
f32 rounding sends one or two of them to the other side of 0 than float64
does (2.1e-8 and 5.1e-6 from it, measured), each moving a row of the tower's
weight gradient by ~1% of its max (1.3e-2 read on cls_convs.1, whose f32
gradient JAX's and float64 agree on to 4e-4), and the second SGD step
flips one in the basis branch (1% of sip_mask_lat0's update)."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import (assert_close, bumped_state_dict, images,
                           jax_variables)
from sipmask_tpu.config import _r, get_config
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models import track as jtrack
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu.train import make_optimizer as j_make_optimizer
from sipmask_tpu.train import make_train_step as j_make_train_step
from sipmask_tpu.train.state import TrainState as JTrainState
from sipmask_tpu.utils import demo_batch as j_demo_batch
from sipmask_tpu_torch.models import track
from sipmask_tpu_torch.models.detector import build_model
from sipmask_tpu_torch.models.loss import compute_losses
from sipmask_tpu_torch.train import create_train_state, make_train_step
from sipmask_tpu_torch.utils.convert import (grads_from_jax, init_weights,
                                             params_from_jax)
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors

HEAD_REL = 1e-4          # the track branch: ~30 f32 layers, reordered
LOSS_RTOL = 1e-4         # tests/test_torch_train.py's
GRAD_REL = 2e-3          # its head and neck gradient tolerance
BACKBONE_GRAD_REL = 3e-2  # its backbone tolerance (f32 rounding, see there)
HW = (128, 160)          # the video driver's bucket
TRAIN_HW = (256, 320)
MAX_POS = 16


def vis_cfg():
    cfg = get_config("sipmask_vis_r50")
    cfg = _r(cfg, "model.fpn", out_channels=32)
    cfg = _r(cfg, "model.head", in_channels=32, feat_channels=32)
    cfg = _r(cfg, "data", img_scale=(160, 128), max_gts=8)
    return _r(cfg, "train", max_pos=MAX_POS)


def vis_batch(seed=7):
    """demo_batch's current frames (40 classes) and a reference frame of
    each: other images, the gt boxes moved a few px with one reference gt
    dropped (ref_labels 0) and gt_pids a permutation with a 0 (an object
    absent from the reference frame)."""
    b = j_demo_batch(2, *TRAIN_HW, 8, num_classes=40, seed=seed)
    rng = np.random.RandomState(seed + 1)
    b["ref_images"] = images(2, *TRAIN_HW, seed=seed + 2)
    n = 4   # demo_batch's gts an image at max_gts 8
    ref = b["gt_bboxes"].copy()
    ref[:, :n] = np.clip(ref[:, :n] + rng.uniform(-4, 4, (2, n, 4)), 0,
                         TRAIN_HW[1] - 1)
    b["ref_bboxes_jit"] = ref.astype(np.float32)
    b["ref_labels"] = b["gt_labels"].copy()
    b["ref_labels"][1, 2] = 0
    pids = np.zeros((2, 8), np.int32)
    pids[0, :n] = [3, 1, 4, 2]
    pids[1, :n] = [2, 0, 1, 4]
    b["gt_pids"] = pids
    return b


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a).transpose(0, 3, 1, 2)))


def head_relu_masks(cfg, sd, batch):
    """The sign masks of every ReLU of the port's head (its GroupNorm ReLUs
    and the basis branch's two), in call order, from a float64 forward of
    both frames (NCHW bool arrays)."""
    import sipmask_tpu_torch.ops.gn_relu as gn_ops
    real_gn, real_relu, masks = gn_ops.gn_relu, torch.relu, []

    def relu(y):
        masks.append((y > 0).numpy())
        return real_relu(y)

    def gn(x, weight, bias, groups=32, eps=1e-5, act=False):
        y = F.group_norm(x, groups, weight, bias, eps)
        return relu(y) if act else y
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    tb = batch_to_tensors(batch)
    with _in_head(model, gn, relu):
        with torch.no_grad():
            model.double()(tb["images"].double(), tb["ref_images"].double())
    return masks


@contextlib.contextmanager
def _in_head(model, gn, relu):
    """The port's gn_relu and torch.relu replaced while ``model``'s head
    runs its forward."""
    import sipmask_tpu_torch.ops.gn_relu as gn_ops
    real_gn, real_relu = gn_ops.gn_relu, torch.relu

    def on(*_):
        gn_ops.gn_relu, torch.relu = gn, relu

    def off(*_):
        gn_ops.gn_relu, torch.relu = real_gn, real_relu
    hooks = [model.bbox_head.register_forward_pre_hook(on),
             model.bbox_head.register_forward_hook(off)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        off()


@contextlib.contextmanager
def pinned_head_relus(model, masks):
    """Within the context the i-th ReLU of each head forward returns
    ``y * masks[i]`` in both packages: in the port's head (``model``'s;
    None: no port model runs) its ``gn_relu`` with act and ``torch.relu``;
    in the JAX package's the ``relu`` of ``GroupNorm32`` and of the head
    module (JAX traces made inside keep the pins)."""
    import sipmask_tpu.models.layers as jlayers
    import sipmask_tpu.models.sipmask_head as jhead
    import sipmask_tpu_torch.ops.gn_relu as gn_ops
    real_gn = gn_ops.gn_relu
    real_jax = (jlayers.relu, jhead.relu)
    calls = {"port": 0, "jax": 0}

    def take(side, shape):
        m = masks[calls[side] % len(masks)]
        calls[side] += 1
        m = m if side == "port" else m.transpose(0, 2, 3, 1)
        assert m.shape == tuple(shape), (side, m.shape, tuple(shape))
        return m

    def relu(y):
        return y * torch.from_numpy(take("port", y.shape))

    def gn(x, weight, bias, groups=32, eps=1e-5, act=False):
        y = real_gn(x, weight, bias, groups, eps, False)
        return relu(y) if act else y

    def jax_relu(y):
        return jnp.where(jnp.asarray(take("jax", y.shape)), y,
                         jnp.zeros((), y.dtype))
    jlayers.relu = jhead.relu = jax_relu
    try:
        with (contextlib.nullcontext() if model is None
              else _in_head(model, gn, relu)):
            yield calls
    finally:
        jlayers.relu, jhead.relu = real_jax


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: under pytest-xdist every
    worker's torch would start one OpenMP thread per core, and six such
    pools spin against each other (the CLI case below took 450 s with six
    copies running at once, 7 s with one thread each)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    cfg = vis_cfg()
    sd = bumped_state_dict(build_model(cfg.model))
    return cfg, sd, jax_variables(sd)


@pytest.fixture(scope="module")
def masks(weights):
    cfg, sd, _ = weights
    return head_relu_masks(cfg, sd, vis_batch())


@pytest.fixture(scope="module")
def jax_grads(weights, masks):
    """JAX's losses, gradients and track features on vis_batch (one
    compile), the head's ReLUs pinned."""
    cfg, _, variables = weights
    jm = j_build_model(cfg.model)
    jb = {k: jnp.asarray(v) for k, v in vis_batch().items()}

    def loss_fn(params):
        out = jm.apply({"params": params,
                        "constants": variables["constants"]},
                       jb["images"], jb["ref_images"])
        losses = j_compute_losses(out, jb, cfg.model.head, max_pos=MAX_POS)
        total = sum(v for k, v in losses.items() if k.startswith("loss"))
        return total, (losses, out["track_feats"], out["track_feats_ref"])

    with pinned_head_relus(None, masks) as calls:
        (_, aux), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(variables["params"])
    assert calls["jax"] == len(masks)
    return jax.tree_util.tree_map(np.asarray, aux), grads


@pytest.fixture(scope="module")
def port_grads(weights, masks):
    cfg, sd, _ = weights
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    tb = batch_to_tensors(vis_batch())
    with pinned_head_relus(model, masks) as calls:
        out = model(tb["images"], tb["ref_images"])
    assert calls["port"] == len(masks)
    losses = compute_losses(out, tb, cfg.model.head, max_pos=MAX_POS)
    sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    return model, out, {k: float(v.detach()) for k, v in losses.items()}


# ------------------------------------------------------------- the model

def test_weight_bridge_covers_the_track_branch():
    """JAX's VIS parameter trees through params_from_jax give exactly the
    port's state_dict, track_convs and sipmask_track included, and the port's
    init gives sip_cof std 0.01 with a tracking head (0.001 without)."""
    cfg = vis_cfg()
    shapes = jax.eval_shape(j_build_model(cfg.model).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, *HW, 3), jnp.float32))
    variables = jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, a.dtype), shapes)
    sd = params_from_jax(variables["params"], variables["constants"])
    model = build_model(cfg.model)
    want = model.state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    assert "bbox_head.track_convs.1.gn.weight" in sd
    assert tuple(sd["bbox_head.sipmask_track.weight"].shape) == (512, 96, 1, 1)
    model.load_state_dict(sd)
    full = build_model(get_config("sipmask_vis_r50").model)
    init_weights(full, torch.Generator().manual_seed(0))
    head = full.bbox_head
    assert abs(float(head.sip_cof.weight.detach().std()) - 0.01) < 1e-3
    assert abs(float(head.sipmask_track.weight.detach().std()) - 0.01) < 1e-3
    assert len(head.track_convs) == 2
    flagship = build_model(get_config("sipmask_r50_fpn_gn_1x").model)
    init_weights(flagship, torch.Generator().manual_seed(0))
    sip_cof = flagship.bbox_head.sip_cof.weight.detach()
    assert abs(float(sip_cof.std()) - 0.001) < 2e-4


def test_track_branch_matches_jax(jax_grads, port_grads):
    (_, tf, tf_ref), _ = jax_grads
    _, out, _ = port_grads
    for key, want in (("track_feats", tf), ("track_feats_ref", tf_ref)):
        got = out[key].detach().permute(0, 2, 3, 1).numpy()
        assert got.shape == (2, TRAIN_HW[0] // 8, TRAIN_HW[1] // 8, 512)
        assert_close(got, want, HEAD_REL, key)


def test_compute_losses_with_match_matches_jax(jax_grads, port_grads):
    """loss_match and match_acc with the rest, the VIS fork's unnormalised
    box decode included; gt_pids are a permutation, so a gt row index of
    another convention than JAX's would move loss_match."""
    (jlosses, _, _), _ = jax_grads
    _, _, got = port_grads
    assert set(got) == set(jlosses)
    assert got["loss_match"] > 0 and got["loss_mask"] > 0
    for k, v in jlosses.items():
        np.testing.assert_allclose(got[k], float(v), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)


def test_whole_model_gradients_match_jax(jax_grads, port_grads):
    """Both frames' backward: the reference frame's path through the
    backbone and FPN carries the match loss's gradient."""
    _, jgrads = jax_grads
    model, _, _ = port_grads
    want = grads_from_jax(jgrads)
    params = dict(model.named_parameters())
    assert set(want) == set(params)
    for n, p in params.items():
        if not p.requires_grad:
            assert p.grad is None and not want[n].any(), n
            continue
        w = want[n].numpy()
        rel = BACKBONE_GRAD_REL if n.startswith("backbone.") else GRAD_REL
        err = float(np.abs(p.grad.numpy() - w).max())
        assert err <= rel * float(np.abs(w).max()), (n, err)
    for n in ("bbox_head.track_convs.0.conv.weight",
              "bbox_head.sipmask_track.weight"):
        assert float(params[n].grad.abs().max()) > 0, n


def test_two_sgd_steps_match_jax(weights, masks):
    cfg, sd, variables = weights
    steps_per_epoch = 10
    jm = j_build_model(cfg.model)
    tx = j_make_optimizer(cfg.train.optim, steps_per_epoch,
                          variables["params"],
                          frozen_stages=cfg.model.backbone.frozen_stages)
    state = JTrainState(step=jnp.zeros((), jnp.int32),
                        params=variables["params"],
                        constants=variables["constants"],
                        opt_state=tx.init(variables["params"]))
    jstep = j_make_train_step(jm, tx, cfg, donate=False)
    batch = vis_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jmetrics = []
    port = create_train_state(cfg, "cpu", state_dict=sd,
                              steps_per_epoch=steps_per_epoch)
    step = make_train_step(port, cfg)
    tb = batch_to_tensors(batch)
    with pinned_head_relus(port.model, masks):
        for _ in range(2):
            state, m = jstep(state, jb)
            jmetrics.append({k: float(v) for k, v in m.items()})
        metrics = [{k: float(v) for k, v in step(tb).items()}
                   for _ in range(2)]
    for i, (got, want) in enumerate(zip(metrics, jmetrics)):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL,
                                       atol=1e-6, err_msg=f"step {i} {k}")
        # match_acc is a metric: loss_total sums the loss* terms only
        np.testing.assert_allclose(
            got["loss_total"], sum(v for k, v in got.items()
                                   if k.startswith("loss_") and
                                   k != "loss_total"), rtol=1e-6)
    p0 = params_from_jax(variables["params"], {})
    want = {n: v.numpy() - p0[n].numpy()
            for n, v in params_from_jax(state.params, {}).items()}
    for n, p in port.model.named_parameters():
        got = p.detach().numpy() - sd[n].numpy()
        if not p.requires_grad:
            assert not got.any() and not want[n].any(), n
            continue
        # tests/test_torch_train.py's room for two steps: 3x the gradient
        # tolerance plus a few f32 units of the weights
        rel = 3 * (BACKBONE_GRAD_REL if n.startswith("backbone.")
                   else GRAD_REL)
        ulps = 4 * float(np.spacing(np.abs(sd[n].numpy()).max()))
        err = float(np.abs(got - want[n]).max())
        assert err <= rel * float(np.abs(want[n]).max()) + ulps, (n, err)


# ------------------------------------------------- center feats, match CE

def _match_inputs(seed=0):
    rng = np.random.RandomState(seed)
    b, k, g, hf, wf, c = 2, 12, 6, 8, 10, 16
    tf = rng.randn(b, hf, wf, c).astype(np.float32)
    tf_ref = rng.randn(b, hf, wf, c).astype(np.float32)
    xy = rng.uniform(-8, 44, (b, k, 2))           # some centres off the grid
    box_sel = np.concatenate([xy, xy + rng.uniform(1, 20, (b, k, 2))],
                             -1).astype(np.float32)
    sel_valid = rng.rand(b, k) < 0.75
    gtidx_sel = rng.randint(0, g, (b, k)).astype(np.int32)
    rxy = rng.uniform(0, 80, (b, g, 2))
    ref_boxes = np.concatenate([rxy, rxy + rng.uniform(4, 30, (b, g, 2))],
                               -1).astype(np.float32)
    ref_labels = rng.randint(0, 3, (b, g)).astype(np.int32)   # 0: padding
    gt_pids = rng.randint(0, g + 1, (b, g)).astype(np.int32)  # 0: no match
    return tf, tf_ref, box_sel, sel_valid, gtidx_sel, ref_boxes, \
        ref_labels, gt_pids


def test_extract_center_feats_matches_jax():
    tf, _, box_sel, *_ = _match_inputs()
    for i in range(2):
        want = np.asarray(jtrack.extract_center_feats(
            jnp.asarray(tf[i]), jnp.asarray(box_sel[i] * 2.0)))
        got = track.extract_center_feats(
            torch.from_numpy(tf[i]).permute(2, 0, 1),
            torch.from_numpy(box_sel[i] * 2.0)).numpy()
        np.testing.assert_array_equal(got, want)


def test_track_match_loss_matches_jax():
    """Fixed selections with invalid selections, padded reference gts and
    gt_pids 0: the batched loss and accuracy, and each image alone."""
    (tf, tf_ref, box_sel, sel_valid, gtidx_sel, ref_boxes, ref_labels,
     gt_pids) = _match_inputs()
    outputs = {"track_feats": tf, "track_feats_ref": tf_ref}
    batch = {"gt_pids": gt_pids, "ref_bboxes_jit": ref_boxes,
             "ref_labels": ref_labels}
    aux = {"box_sel": box_sel, "sel_valid": sel_valid,
           "gtidx_sel": gtidx_sel}
    want = jax.jit(jtrack.track_match_loss)(
        *(jax.tree_util.tree_map(jnp.asarray, t)
          for t in (outputs, batch, aux)))
    t = lambda a: torch.from_numpy(np.asarray(a))   # noqa: E731
    got = track.track_match_loss(
        {k: _nchw(v) for k, v in outputs.items()},
        {k: t(v) for k, v in batch.items()}, t(box_sel), t(sel_valid),
        t(gtidx_sel))
    assert float(want[0]) > 0 and 0 < float(want[1]) < 1
    for g, w, name in zip(got, want, ("loss_match", "match_acc")):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for i in range(2):
        wi = jtrack.track_match_loss_single(
            jnp.asarray(tf[i]), jnp.asarray(tf_ref[i]),
            jnp.asarray(box_sel[i]), jnp.asarray(sel_valid[i]),
            jnp.asarray(gtidx_sel[i]), jnp.asarray(gt_pids[i]),
            jnp.asarray(ref_boxes[i]), jnp.asarray(ref_labels[i] > 0))
        gi = track.track_match_loss_single(
            t(tf[i]).permute(2, 0, 1), t(tf_ref[i]).permute(2, 0, 1),
            t(box_sel[i]), t(sel_valid[i]), t(gtidx_sel[i]), t(gt_pids[i]),
            t(ref_boxes[i]), t(ref_labels[i] > 0))
        for g, w in zip(gi, wi):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                       atol=1e-6)


def test_jitter_boxes_stays_within_the_amplitude():
    """The reference-box jitter moves each centre by at most amplitude x
    the box size and scales each side by at most 1 +- amplitude, draws
    from the given generator (the same seed: the same boxes), and leaves
    the boxes as they are at amplitude 0."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 100, (50, 2))
    boxes = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(5, 40, (50, 2))], 1).astype(np.float32))
    out = track.jitter_boxes(boxes, torch.Generator().manual_seed(1), 0.1)
    again = track.jitter_boxes(boxes, torch.Generator().manual_seed(1), 0.1)
    assert torch.equal(out, again) and not torch.equal(out, boxes)
    wh, owh = boxes[:, 2:] - boxes[:, :2], out[:, 2:] - out[:, :2]
    shift = ((out[:, :2] + out[:, 2:]) - (boxes[:, :2] + boxes[:, 2:])) / 2
    assert bool((shift.abs() <= 0.1 * wh + 1e-4).all())
    assert bool(((owh / wh - 1).abs() <= 0.1 + 1e-5).all())
    same = track.jitter_boxes(boxes, torch.Generator().manual_seed(1), 0.0)
    torch.testing.assert_close(same, boxes)


# ---------------------------------------------------------------- tracker

def _eye(n, dim=512):
    return np.eye(n, dim, dtype=np.float32) * 5


# tests/test_vis.py's sequences: frames of (boxes, scores, labels, valid,
# feats), with the tracker's capacity
SEQUENCES = {
    "first frame": (8, [([[0, 0, 10, 10], [20, 20, 30, 30]], [0.9, 0.8],
                         [1, 2], [1, 1], np.ones((2, 512), np.float32) * .1)]),
    "same object": (8, [([[0, 0, 10, 10], [40, 40, 50, 50]], [0.9, 0.8],
                         [1, 2], [1, 1], _eye(2)),
                        ([[2, 2, 12, 12], [42, 42, 52, 52]], [0.85, 0.8],
                         [1, 2], [1, 1], _eye(2))]),
    "new object": (8, [([[0, 0, 10, 10]], [0.9], [1], [1], _eye(3)[:1]),
                       ([[60, 60, 70, 70]], [0.9], [2], [1], _eye(3)[1:2])]),
    "invalid detections": (4, [(np.zeros((3, 4)), [0, 0, 0], [0, 0, 0],
                                [0, 0, 0], np.zeros((3, 512), np.float32))]),
    "LRU eviction": (4, [([[100. * k, 0, 100. * k + 10, 10]], [0.9], [k + 1],
                          [1], _eye(7)[k:k + 1]) for k in range(7)]),
    "protected slot": (2, [([[0, 0, 10, 10], [200, 0, 210, 10]], [0.9, 0.9],
                            [1, 2], [1, 1], _eye(3)[:2]),
                           ([[400, 0, 410, 10], [1, 0, 11, 10]], [0.9, 0.9],
                            [3, 1], [1, 1], _eye(3)[[2, 0]])]),
}


def _random_stream(seed=3, frames=12, d=6, m=4, dim=16):
    """12 frames of up to 6 detections of 8 objects that move, leave and
    come back, with invalid slots and a capacity of 4 (evictions): feats
    on a 1/4 grid so that the dot products are exact in f32."""
    rng = np.random.RandomState(seed)
    emb = np.round(rng.randn(8, dim) * 4) / 4
    pos = rng.uniform(0, 200, (8, 2))
    vel = rng.uniform(-6, 6, (8, 2))
    lab = rng.randint(1, 4, 8)
    out = []
    for f in range(frames):
        objs = rng.choice(8, d, replace=False)
        p = pos[objs] + vel[objs] * f
        boxes = np.round(np.concatenate([p, p + 20], 1))
        feats = (emb[objs] + np.round(rng.randn(d, dim)) / 4).astype(
            np.float32)
        scores = np.round(rng.uniform(0.05, 1.0, d), 3)
        labels = np.where(rng.rand(d) < 0.85, lab[objs], rng.randint(1, 4, d))
        valid = rng.rand(d) < 0.8
        out.append((boxes, scores, labels, valid, feats))
    return m, out


@pytest.mark.parametrize("name", list(SEQUENCES) + ["random stream"])
def test_tracker_step_matches_jax(name):
    """Object ids exactly, and the whole state after every frame."""
    m, frames = (_random_stream() if name == "random stream"
                 else SEQUENCES[name])
    dim = frames[0][4].shape[1]
    jstate, state = jtrack.tracker_init(m, dim), track.tracker_init(m, dim)
    jstep = jax.jit(jtrack.tracker_step)
    all_ids = []
    for f, (boxes, scores, labels, valid, feats) in enumerate(frames):
        arrs = (np.asarray(boxes, np.float32), np.asarray(scores, np.float32),
                np.asarray(labels, np.int32), np.asarray(valid, bool),
                np.asarray(feats, np.float32))
        jstate, jids = jstep(jstate, *map(jnp.asarray, arrs),
                             jnp.asarray(f == 0))
        state, ids = track.tracker_step(state, *map(torch.from_numpy, arrs),
                                        f == 0)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids),
                                      err_msg=f"{name}, frame {f}")
        all_ids.append(ids.tolist())
        for field in track.TrackerState._fields:
            np.testing.assert_array_equal(
                getattr(state, field).numpy(),
                np.asarray(getattr(jstate, field)),
                err_msg=f"{name}, frame {f}, {field}")
    if name == "LRU eviction":
        assert [i[0] for i in all_ids] == list(range(7))
        assert int(state.overflow) == 3
    if name == "protected slot":
        assert all_ids[1] == [2, 0]
    if name == "random stream":
        assert int(state.overflow) > 0 and int(state.count) > m


# ---------------------------------------------------------- video driver

def test_run_video_inference_matches_jax(weights, tmp_path):
    """A tiny PNG video set (3 videos of 3 frames, 96x96, written by the
    port's synth_ytvis) through both packages' run_video_inference on the
    same weights: the same tracks in the same order, categories, scores to
    1e-5 and the RLEs byte for byte; then finite YTVIS stats from both
    evaluators, equal."""
    from sipmask_tpu.apis.test_video import (
        run_video_inference as j_run_video_inference)
    from sipmask_tpu.data.ytvos import YTVOSDataset as JDataset
    from sipmask_tpu.eval.ytvos_eval import YTVOSEvaluator as JEvaluator
    from sipmask_tpu_torch.apis.inference import Detector
    from sipmask_tpu_torch.apis.test_video import run_video_inference
    from sipmask_tpu_torch.data.ytvos import YTVOSDataset
    from sipmask_tpu_torch.eval.ytvos_eval import YTVOSEvaluator
    from sipmask_tpu_torch.tools.synth_ytvis import make_dataset
    cfg, sd, variables = weights
    cfg = _r(cfg, "model.track", max_tracks=8)
    ann, imgs = make_dataset(str(tmp_path), num_videos=3, frames=3, size=96,
                             seed=1, max_objects=3)
    want = j_run_video_inference(j_build_model(cfg.model), variables, cfg,
                                 JDataset(ann, imgs, test_mode=True),
                                 progress=False)
    model = build_model(cfg.model)
    model.load_state_dict(sd)
    got = run_video_inference(Detector(cfg, model.eval(), "cpu"),
                              YTVOSDataset(ann, imgs, test_mode=True),
                              progress=False)
    assert len(got) == len(want) > 3
    for g, w in zip(got, want):
        assert (g["video_id"], g["category_id"]) == (w["video_id"],
                                                     w["category_id"])
        np.testing.assert_allclose(g["score"], w["score"], rtol=0, atol=1e-5)
        assert len(g["segmentations"]) == len(w["segmentations"]) == 3
        for a, b in zip(g["segmentations"], w["segmentations"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a["size"] == list(b["size"])
                assert a["counts"] == b["counts"]
    ev, jev = YTVOSEvaluator(ann), JEvaluator(ann)
    ev.update(got)
    jev.update(want)
    stats, jstats = ev.summarize(verbose=False), jev.summarize(verbose=False)
    assert stats == jstats and all(np.isfinite(v) for v in stats.values())


SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
          "model.head.feat_channels=32", "data.img_scale=(160,128)",
          "data.max_gts=6", "data.num_workers=1", "train.imgs_per_device=2",
          "train.max_pos=16", "train.log_interval=1"]


def test_vis_train_and_test_clis(weights, tmp_path):
    """tools/train.py with a VIS preset on a synthetic YouTube-VIS set
    (frame pairs through train_detector, the YTVIS eval hook from
    --val-ann) for 2 steps, then tools/test_video.py --eval on its
    checkpoint: a log line a step with loss_match and match_acc, the
    hook's stats in the log, YTVIS classes in the checkpoint, and a
    results json whose RLEs decode."""
    import json
    import os
    from sipmask_tpu_torch.eval.rle import decode_mask, rle_area
    from sipmask_tpu_torch.tools import test_video as test_cli
    from sipmask_tpu_torch.tools import train as train_cli
    from sipmask_tpu_torch.tools.synth_ytvis import make_dataset
    from sipmask_tpu_torch.utils.checkpoint import latest_checkpoint
    _, sd, _ = weights
    bumped = str(tmp_path / "bumped.pth")
    torch.save(sd, bumped)
    ann, imgs = make_dataset(str(tmp_path / "vis"), num_videos=2, frames=3,
                             size=96, seed=3)
    wd = str(tmp_path / "wd")
    state = train_cli.main(["sipmask_vis_r50", "--ann", ann, "--img-prefix",
                            imgs, "--work-dir", wd, "--load-from", bumped,
                            "--max-steps", "2", "--val-ann", ann, "--device",
                            "cpu", "--cfg-options", *SHRINK])
    assert state.step == 2
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if "loss_total" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss_match"]) and 0 <= r["match_acc"] <= 1
               for r in steps)
    val = [r for r in lines if "val/segm/AP" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val/segm/AP"])
    ckpt = latest_checkpoint(wd)
    meta = torch.load(ckpt, weights_only=False)["meta"]
    assert meta["classes"][0] == "person" and len(meta["classes"]) == 40
    out = str(tmp_path / "results.json")
    results, stats = test_cli.main(["sipmask_vis_r50", ckpt, "--ann", ann,
                                    "--img-prefix", imgs, "--out", out,
                                    "--eval", "--device", "cpu",
                                    "--cfg-options", *SHRINK])
    assert results and all(np.isfinite(v) for v in stats.values())
    with open(out) as f:
        saved = json.load(f)
    assert len(saved) == len(results)
    for r in saved:
        assert len(r["segmentations"]) == 3
        for seg in r["segmentations"]:
            if seg is not None:
                assert int(decode_mask(seg).sum()) == rle_area(seg)
