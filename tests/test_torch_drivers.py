"""The port's train and test drivers on the CPU at golden's shrink (FPN and
head 32 wide, stacked_convs 2, test scale 160x128), on a synthetic COCO set
written by the port's synth tool: ``train_detector``'s checkpoints and
resume, ``load_weights``, ``grad_clip``, ``run_inference`` against
``inference_detector`` and ``evaluate_coco``, through the CLIs."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import bumped_state_dict
from sipmask_tpu_torch.apis.train import train_detector
from sipmask_tpu_torch.config import _r, apply_overrides, get_config
from sipmask_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                load_weights, save_checkpoint)
from sipmask_tpu_torch.utils.demo_inputs import batch_to_tensors

SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
          "model.head.feat_channels=32", "model.head.stacked_convs=2",
          "data.img_scale=(160,128)", "data.max_gts=8",
          "data.num_workers=1", "train.imgs_per_device=2",
          "train.max_pos=16", "train.log_interval=1"]


def _cfg():
    return apply_overrides(get_config("sipmask_r50_fpn_gn_1x"), SHRINK)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """4 landscape images at 160x120 and 150x100 and 2 portrait ones: 3
    steps an epoch at batch 2."""
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    out = str(tmp_path_factory.mktemp("synth"))
    return make_dataset(out, sizes=((160, 120), (150, 100), (120, 160)),
                        repeat=2, min_objs=3, max_objs=6, seed=2)


@pytest.fixture(scope="module")
def bumped(tmp_path_factory):
    """Weights whose decode keeps detections and whose mask loss is not 0,
    saved as a bare state_dict file with a ``num_batches_tracked`` entry,
    as mmdet's released files have."""
    from sipmask_tpu_torch.models.detector import build_model
    sd = bumped_state_dict(build_model(_cfg().model))
    path = str(tmp_path_factory.mktemp("w") / "bumped.pth")
    torch.save(dict(sd, **{"backbone.bn1.num_batches_tracked":
                           torch.tensor(5)}), path)
    return path, sd


def _state_equal(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for k in oa["state"]:
        assert torch.equal(oa["state"][k]["momentum_buffer"],
                           ob["state"][k]["momentum_buffer"]), k
    assert a.step == b.step
    assert a.schedule(a.step) == b.schedule(b.step)


def test_train_detector_checkpoints_and_resumes_bit_for_bit(synth, bumped,
                                                            tmp_path):
    """3 steps from load_from (one epoch: epoch_1.pth, last_checkpoint,
    log lines), then a resume that has nothing left to do restores the
    same weights, momentum, step and lr bit for bit, and two resumed steps
    equal the straight run's next two steps on the same batches."""
    cfg = _cfg()
    wd = str(tmp_path / "wd")
    state = train_detector(cfg, *synth, wd, load_from=bumped[0],
                           max_steps=3, device="cpu")
    assert state.step == 3
    assert latest_checkpoint(wd) == os.path.join(wd, "epoch_1.pth")
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2, 3]
    keys = {"lr", "loss_cls", "loss_bbox", "loss_centerness", "loss_mask",
            "loss_total"}
    assert all(keys <= set(r) and np.isfinite(r["loss_total"])
               for r in lines)
    assert lines[-1]["loss_mask"] > 0
    frozen = [n for n, p in state.model.named_parameters()
              if not p.requires_grad]
    assert frozen and all(torch.equal(state.model.state_dict()[n],
                                      bumped[1][n]) for n in frozen)

    resumed = train_detector(cfg, *synth, wd, max_steps=3, device="cpu")
    _state_equal(resumed, state)

    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    from sipmask_tpu_torch.train import make_train_step
    loader, _ = build_train_loader(CocoDataset(*synth),
                                   TrainTransform(cfg.data, 1), 2, seed=1,
                                   num_workers=1)
    batches = [batch_to_tensors(next(loader), "cpu") for _ in range(2)]
    loader.close()
    straight = make_train_step(state, cfg)
    again = make_train_step(resumed, cfg)
    for batch in batches:
        m1, m2 = straight(batch), again(batch)
        for k in m1:
            assert torch.equal(m1[k], m2[k]), k
    _state_equal(resumed, state)


def test_train_detector_resumes_at_its_step_and_goes_on(synth, tmp_path):
    """max_steps 4 after a 2-step run: resumes at step 2 from epoch_0 (the
    last step's checkpoint, mid-epoch), checkpoints at the epoch's end
    (step 3) and at its last step, both epoch_1."""
    cfg = _cfg()
    wd = str(tmp_path / "wd")
    train_detector(cfg, *synth, wd, max_steps=2, device="cpu")
    assert latest_checkpoint(wd) == os.path.join(wd, "epoch_0.pth")
    state = train_detector(cfg, *synth, wd, max_steps=4, device="cpu")
    assert state.step == 4
    assert latest_checkpoint(wd) == os.path.join(wd, "epoch_1.pth")
    ckpt = torch.load(latest_checkpoint(wd), weights_only=False)
    assert ckpt["step"] == 4 and ckpt["meta"]["config"] == cfg.name


def test_load_weights_takes_checkpoints_and_bare_state_dicts(bumped,
                                                             tmp_path):
    from sipmask_tpu_torch.train import create_train_state
    cfg = _cfg()
    state = create_train_state(cfg, "cpu", seed=9)
    load_weights(bumped[0], state.model)   # bare, num_batches_tracked too
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, bumped[1][k]), k
    path = str(tmp_path / "epoch_1.pth")
    save_checkpoint(path, state, meta={"config": cfg.name})
    other = create_train_state(cfg, "cpu", seed=10)
    load_weights(path, other.model)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, bumped[1][k]), k
    assert latest_checkpoint(str(tmp_path)) == path


def test_grad_clip_scales_by_the_global_norm():
    """min(1, clip / (norm + 1e-6)) with the global L2 norm over every
    gradient, as the JAX package's optimizer computes it."""
    from sipmask_tpu_torch.train.optim import clip_gradients
    rng = np.random.RandomState(0)
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in ((3, 4), (5,), (2,))]
    grads = [rng.randn(*p.shape).astype(np.float32) for p in ps]
    for p, g in zip(ps, grads):
        p.grad = torch.from_numpy(g.copy())
    opt = torch.optim.SGD(ps, lr=0.1)
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads))
    clip_gradients(opt, 0.5)
    for p, g in zip(ps, grads):
        np.testing.assert_allclose(p.grad.numpy(), g * 0.5 / (norm + 1e-6),
                                   rtol=1e-6)
    clip_gradients(opt, 1e3)    # under the limit: unchanged
    for p, g in zip(ps, grads):
        np.testing.assert_allclose(p.grad.numpy(), g * 0.5 / (norm + 1e-6),
                                   rtol=1e-6)


def test_soft_nms_inference_and_proposal_fast_through_the_drivers(synth,
                                                                 bumped):
    """``run_inference`` with ``test.nms_type="soft_nms"`` (gaussian) against
    ``inference_detector`` on the same weights (boxes, labels, scores,
    masks), other detections than hard NMS's; then tools/test.py with
    ``--eval bbox segm proposal_fast`` and the soft-NMS override (linear):
    finite COCO stats and AR@100/300/1000 in [0, 1]."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector)
    from sipmask_tpu_torch.apis.test import run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.eval.rle import decode_mask
    from sipmask_tpu_torch.tools import test as test_cli
    soft = _r(_cfg(), "model.test", nms_type="soft_nms",
              soft_nms_method="gaussian")
    det = init_detector(soft, "cpu")
    det.model.load_state_dict(bumped[1])
    ds = CocoDataset(*synth, test_mode=True)
    results = run_inference(det, ds, batch_size=2, progress=False)
    hard = init_detector(_cfg(), "cpu")
    hard.model.load_state_dict(bumped[1])
    hard = inference_detector(hard, ds.load_image(0))
    cat2label = {c: lab for lab, c in ds.label2cat.items()}
    for i in (0, len(ds) - 1):
        mine = [r for r in results if r["image_id"] == ds.image_id(i)]
        ref = inference_detector(det, ds.load_image(i))
        assert len(mine) == len(ref["labels"]) > 0
        np.testing.assert_allclose(
            [[x, y, x + w, y + h] for x, y, w, h in (r["bbox"]
                                                     for r in mine)],
            ref["boxes"], rtol=0, atol=1e-3)
        assert [cat2label[r["category_id"]] - 1 for r in mine] == \
            ref["labels"].tolist()
        np.testing.assert_allclose([r["score"] for r in mine],
                                   ref["scores"], rtol=0, atol=1e-6)
        masks = np.stack([decode_mask(r["segmentation"]) for r in mine])
        assert (masks == ref["masks"]).mean() >= 0.99
        if i == 0:   # the same first pick; then what hard NMS suppresses
            assert ref["scores"][0] == hard["scores"][0]
            assert set(zip(ref["labels"].tolist(), ref["scores"].tolist())
                       ) != set(zip(hard["labels"].tolist(),
                                    hard["scores"].tolist()))
    stats = test_cli.main(["sipmask_r50_fpn_gn_1x", bumped[0], "--ann",
                           synth[0], "--img-prefix", synth[1],
                           "--batch-size", "2", "--device", "cpu",
                           "--eval", "bbox", "segm", "proposal_fast",
                           "--cfg-options", *SHRINK,
                           "model.test.nms_type=soft_nms"])
    assert set(stats) == {"bbox", "segm", "proposal_fast"}
    assert set(stats["proposal_fast"]) == {"AR@100", "AR@300", "AR@1000"}
    for it in ("bbox", "segm"):
        assert all(np.isfinite(v) and -1 <= v <= 1
                   for v in stats[it].values())
    assert all(0 <= v <= 1 for v in stats["proposal_fast"].values())


def _pair_near_ties(scores, boxes, labels, ref):
    """For each detection in order, the index of its reference detection:
    the same position, or else an unused one with a score within 1e-5 and
    the same box (1e-3) and label. Unpaired rows keep their position, for
    the assertions to report."""
    order, used = [], set()
    for i, (s, b, lab) in enumerate(zip(scores, boxes, labels)):
        cands = [i] + [j for j in range(len(ref["scores"])) if j != i]
        pick = next((j for j in cands if j not in used
                     and abs(ref["scores"][j] - s) <= 1e-5
                     and np.abs(ref["boxes"][j] - b).max() <= 1e-3
                     and ref["labels"][j] == lab), i)
        used.add(pick)
        order.append(pick)
    return np.asarray(order)


def test_run_inference_matches_inference_detector(synth, bumped):
    """Every test batch (landscape, then portrait; the last batch of each
    group padded) against single-image inference_detector on the same
    weights: scores to 1e-5, boxes to 1e-3, masks with >= 99% of pixels
    equal, each RLE decoding to its mask; then finite COCO stats in
    [-1, 1]. Detections are paired in order, except that two whose scores
    agree to 1e-5 may stand in either order (the batch's float rounding
    can swap a near-tie)."""
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector)
    from sipmask_tpu_torch.apis.test import evaluate_coco, run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.eval.rle import decode_mask
    cfg = _cfg()
    det = init_detector(cfg, "cpu")
    det.model.load_state_dict(bumped[1])
    ds = CocoDataset(*synth, test_mode=True)
    results = run_inference(det, ds, batch_size=3, progress=False)
    assert {r["image_id"] for r in results} == {ds.image_id(i)
                                                for i in range(len(ds))}
    cat2label = {c: lab for lab, c in ds.label2cat.items()}
    for i in range(len(ds)):
        mine = [r for r in results if r["image_id"] == ds.image_id(i)]
        ref = inference_detector(det, ds.load_image(i))
        assert len(mine) == len(ref["labels"]) > 0
        boxes = np.asarray([[x, y, x + w, y + h]
                            for x, y, w, h in (r["bbox"] for r in mine)])
        labels = [cat2label[r["category_id"]] - 1 for r in mine]
        order = _pair_near_ties([r["score"] for r in mine], boxes, labels,
                                ref)
        np.testing.assert_allclose([r["score"] for r in mine],
                                   ref["scores"][order], rtol=0, atol=1e-5)
        np.testing.assert_allclose(boxes, ref["boxes"][order], rtol=0,
                                   atol=1e-3)
        assert labels == ref["labels"][order].tolist()
        masks = np.stack([decode_mask(r["segmentation"]) for r in mine])
        assert masks.shape == ref["masks"].shape
        assert (masks == ref["masks"][order]).mean() >= 0.99
    stats = evaluate_coco(results, synth[0])
    for it in ("bbox", "segm"):
        assert all(np.isfinite(v) and -1 <= v <= 1
                   for v in stats[it].values())


def test_train_and_test_clis(synth, bumped, tmp_path):
    """tools/train.py for one step with grad_clip from --cfg-options and
    the eval hook (--val-ann: evaluates after the checkpoint, records the
    stats in the log and the best checkpoint), then tools/test.py on its
    checkpoint with --out."""
    from sipmask_tpu_torch.tools import test as test_cli
    from sipmask_tpu_torch.tools import train as train_cli
    ann, images = synth
    wd = str(tmp_path / "wd")
    opts = SHRINK + ["train.optim.grad_clip=1.0"]
    state = train_cli.main(["sipmask_r50_fpn_gn_1x", "--ann", ann,
                            "--img-prefix", images, "--work-dir", wd,
                            "--load-from", bumped[0], "--max-steps", "1",
                            "--val-ann", ann, "--device", "cpu",
                            "--cfg-options", *opts])
    assert state.step == 1
    with open(os.path.join(wd, "train.log.json")) as f:
        val = [json.loads(line) for line in f][-1]
    assert val["step"] == 1 and np.isfinite(val["val/segm/AP"])
    with open(os.path.join(wd, "best_checkpoint")) as f:
        assert f.readline().strip() == latest_checkpoint(wd)
    out = str(tmp_path / "results.json")
    stats = test_cli.main(["sipmask_r50_fpn_gn_1x", latest_checkpoint(wd),
                           "--ann", ann, "--img-prefix", images, "--out",
                           out, "--batch-size", "2", "--device", "cpu",
                           "--cfg-options", *SHRINK])
    assert set(stats) == {"bbox", "segm"}
    with open(out) as f:
        saved = json.load(f)
    assert saved and all(isinstance(r["segmentation"]["counts"], str)
                         for r in saved)


RT_SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
             "model.head.feat_channels=32", "data.fixed_size=(128,128)",
             "data.train_size=(160,160)", "data.max_gts=8",
             "data.num_workers=1", "train.imgs_per_device=2",
             "train.max_pos=16", "train.log_interval=1"]


def test_train_detector_trains_the_real_time_preset(synth, tmp_path):
    """sipmask_r50_fpn_ssd_6x (norm-free 2-conv head, ssd_flag, the SSD
    augmentations, repeat_times 3, a 160 train stretch against a 128 test
    size at this shrink) through tools/train.py for 2 steps, from weights
    whose frozen BN standardises the loader's images (a norm-free head
    saturates on a random backbone's raw activations): finite losses, a
    non-zero mask loss; 9 steps an epoch (3 at batch 2, times 3)."""
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    from sipmask_tpu_torch.models.detector import build_model
    from sipmask_tpu_torch.tools import train as train_cli
    from sipmask_tpu_torch.utils.convert import init_weights
    from sipmask_tpu_torch.utils.demo_inputs import (bump_weights,
                                                     calibrate_frozen_bn)
    cfg = apply_overrides(get_config("sipmask_r50_fpn_ssd_6x"), RT_SHRINK)
    assert cfg.data.ssd_augs and cfg.data.repeat_times == 3
    assert cfg.model.head.norm is None and cfg.model.head.ssd_flag
    model = build_model(cfg.model)
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    loader, steps = build_train_loader(
        CocoDataset(*synth), TrainTransform(cfg.data, 0), 2, seed=0,
        repeat_times=cfg.data.repeat_times, num_workers=1)
    images = batch_to_tensors(next(loader))["images"]
    loader.close()
    assert images.shape == (2, 3, 160, 160) and steps == 9
    calibrate_frozen_bn(model.backbone, images)
    bump_weights(model, gen, training=True)
    weights = str(tmp_path / "rt.pth")
    torch.save(model.state_dict(), weights)
    wd = str(tmp_path / "wd")
    state = train_cli.main(["sipmask_r50_fpn_ssd_6x", "--ann", synth[0],
                            "--img-prefix", synth[1], "--work-dir", wd,
                            "--load-from", weights, "--max-steps", "2",
                            "--device", "cpu", "--cfg-options", *RT_SHRINK])
    assert state.step == 2
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines] == [1, 2]
    assert all(np.isfinite(r["loss_total"]) and r["loss_cls"] < 20
               for r in lines)
    assert lines[-1]["loss_mask"] > 0
