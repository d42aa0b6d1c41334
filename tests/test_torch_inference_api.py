"""The port's serving helpers and image CLIs against the JAX package's on
the CPU: ``async_inference_detector`` (concurrent requests give the
sequential results), ``show_result`` (the JAX package's cv2 drawing, pixel
for pixel, written as ``cv2.imwrite`` writes it), ``tools/demo.py``,
``tools/video_demo.py`` with a VIS preset (the JAX tool's tracker loop on
the same frames and weights: the same ids) and ``tools/browse_dataset.py``
(the JAX tool's files byte for byte). One torch thread: under ``-n 6``
torch's per-worker OpenMP pools spin against each other."""

import asyncio
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from _torch_parity import bumped_state_dict, jax_variables, shrunk_cfg
from sipmask_tpu.apis.inference import show_result as j_show_result
from sipmask_tpu_torch.apis.inference import (async_inference_detector,
                                              inference_detector,
                                              init_detector, show_result)
from sipmask_tpu_torch.data.coco import COCO_CLASSES

VIS_SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
              "model.head.feat_channels=32", "data.img_scale=(160,128)",
              "model.track.max_tracks=8"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def det():
    cfg = shrunk_cfg()
    d = init_detector(cfg, "cpu")
    d.model.load_state_dict(bumped_state_dict(d.model))
    return d


def _img(seed, h=120, w=160):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_off():
    return not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)


def test_async_requests_at_once_equal_sequential_ones(det):
    imgs = [_img(s) for s in range(3)]
    want = [inference_detector(det, im) for im in imgs]

    async def run_all():
        return await asyncio.gather(*[async_inference_detector(det, im)
                                      for im in imgs])
    got = asyncio.run(run_all())
    assert sum(len(w["labels"]) for w in want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_show_result_draws_the_jax_packages_pixels(det, tmp_path):
    """Boxes, half-and-half mask blends and labels of the detections above
    a threshold, over an image, as the JAX package's cv2 calls draw them;
    the JPEG written is cv2.imwrite's."""
    img = _img(7)
    res = inference_detector(det, img)
    thr = float(np.median(res["scores"]))
    assert (res["scores"] >= thr).sum() >= 3
    out = str(tmp_path / "mine.jpg")
    got = show_result(img, res, COCO_CLASSES, score_thr=thr, out_file=out)
    want = j_show_result(img, res, COCO_CLASSES, score_thr=thr,
                         out_file=str(tmp_path / "cv2.jpg"))
    assert (got != img).any()
    np.testing.assert_array_equal(got, want)
    with open(out, "rb") as a, open(tmp_path / "cv2.jpg", "rb") as b:
        assert a.read() == b.read()


def test_demo_cli(det, tmp_path, capsys):
    from sipmask_tpu_torch.data import image_io
    from sipmask_tpu_torch.tools import demo
    path = str(tmp_path / "in.jpg")
    image_io.imwrite_jpeg(path, _img(8))
    ckpt = str(tmp_path / "w.pth")
    torch.save(det.model.state_dict(), ckpt)
    out = str(tmp_path / "out.jpg")
    _tf32_on()
    res = demo.main(["sipmask_r50_fpn_gn_1x", path, "--checkpoint", ckpt,
                     "--out", out, "--device", "cpu", "--cfg-options",
                     "model.fpn.out_channels=32", "model.head.in_channels=32",
                     "model.head.feat_channels=32",
                     "model.head.stacked_convs=2",
                     "data.img_scale=(160,128)"])
    assert _tf32_off()
    assert f"wrote {out} with {len(res['boxes'])} detections" in \
        capsys.readouterr().out
    img = cv2.imread(path)
    want = inference_detector(det, img)
    np.testing.assert_array_equal(res["labels"], want["labels"])
    ok, enc = cv2.imencode(".jpg", j_show_result(img, want, COCO_CLASSES))
    with open(out, "rb") as f:
        assert f.read() == enc.tobytes()


def _vis_configs():
    from sipmask_tpu.config import apply_overrides as j_apply
    from sipmask_tpu.config import get_config as j_get
    from sipmask_tpu_torch.config import apply_overrides, get_config
    return (apply_overrides(get_config("sipmask_vis_r50"), VIS_SHRINK),
            j_apply(j_get("sipmask_vis_r50"), VIS_SHRINK))


def test_video_demo_tracks_as_the_jax_tool(tmp_path, capsys):
    """A VIS preset over a directory of 4 JPEG frames: each frame's object
    ids (the tracker's) those of the JAX tool's loop on the same frames and
    weights; each frame written is cv2's drawing of the port's tracked
    boxes and ids, encoded as cv2 encodes it; image sequences only."""
    import jax
    import jax.numpy as jnp
    from sipmask_tpu.apis.inference import Detector as JDetector
    from sipmask_tpu.models import build_model as j_build_model
    from sipmask_tpu.models.decode import decode_batch as j_decode
    from sipmask_tpu.models.track import extract_center_feats as j_feats
    from sipmask_tpu.models.track import tracker_init as j_init
    from sipmask_tpu.models.track import tracker_step as j_step
    from sipmask_tpu_torch.models.detector import build_model
    from sipmask_tpu_torch.tools import video_demo
    from sipmask_tpu_torch.tools.synth_ytvis import make_dataset
    cfg, jcfg = _vis_configs()
    sd = bumped_state_dict(build_model(cfg.model))
    ckpt = str(tmp_path / "vis.pth")
    torch.save(sd, ckpt)
    _, imgs = make_dataset(str(tmp_path / "set"), num_videos=1, frames=4,
                           size=96, seed=2, max_objects=2)
    frames_dir = os.path.join(imgs, "v000")
    out = str(tmp_path / "out" / "%03d.jpg")
    thr = 0.05
    _tf32_on()
    got = video_demo.main(["sipmask_vis_r50", frames_dir, "--checkpoint",
                           ckpt, "--out", out, "--score-thr", str(thr),
                           "--device", "cpu", "--cfg-options", *VIS_SHRINK])
    assert _tf32_off()
    assert f"wrote {out} (4 frames)" in capsys.readouterr().out
    # the JAX tool's VIS loop (tools/video_demo.py) on the same frames
    variables = jax_variables(sd)
    jm = j_build_model(jcfg.model)
    jdet = JDetector(jcfg, jm, variables)

    @jax.jit
    def vis_infer(v, images, img_shapes, scale_factors):
        o = jm.apply(v, images)
        d = j_decode(o, img_shapes, scale_factors, jcfg.model)
        return d, j_feats(o["track_feats"][0],
                          d["boxes"][0] * scale_factors[0][None, :])
    state = j_init(jcfg.model.track.max_tracks)
    files = sorted(os.listdir(frames_dir))
    drawn_any = 0
    for fi, name in enumerate(files):
        frame = cv2.imread(os.path.join(frames_dir, name))
        s = jdet.transform(frame)
        d, feats = vis_infer(variables, jnp.asarray(s.image[None]),
                             jnp.asarray(s.img_shape[None]),
                             jnp.asarray(s.scale_factor[None]))
        state, ids = j_step(state, d["boxes"][0], d["scores"][0],
                            d["labels"][0], d["valid"][0], feats,
                            jnp.asarray(fi == 0),
                            match_coeff=jcfg.model.track.match_coeff)
        valid = np.asarray(d["valid"][0])
        scores = np.asarray(d["scores"][0])
        keep = valid & (scores >= thr)
        mine = got[fi]
        np.testing.assert_array_equal(mine["valid"], valid)
        np.testing.assert_array_equal(np.asarray(mine["ids"])[keep],
                                      np.asarray(ids)[keep])
        # the frame: the JAX tool's cv2 calls on the port's detections
        want = frame.copy()
        colors = np.random.RandomState(7).randint(0, 255, (256, 3))
        for oid, box, score in mine["drawn"]:
            x1, y1, x2, y2 = box.astype(int)
            c = tuple(int(v) for v in colors[oid % 256])
            cv2.rectangle(want, (x1, y1), (x2, y2), c, 2)
            cv2.putText(want, f"id{oid} {score:.2f}", (x1, y1 - 3),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1)
        drawn_any += len(mine["drawn"])
        ok, enc = cv2.imencode(".jpg", want)
        with open(out % fi, "rb") as f:
            assert f.read() == enc.tobytes(), fi
    assert drawn_any > 0
    for bad in ([frames_dir, "--out", str(tmp_path / "x.mp4")],
                ["0"], [str(tmp_path / "clip.mp4")]):
        with pytest.raises(SystemExit, match="image sequence"):
            video_demo.main(["sipmask_vis_r50", *bad, "--device", "cpu"])


def test_browse_dataset_writes_the_jax_tools_files(tmp_path, monkeypatch,
                                                   capsys):
    """2 samples of a synthetic COCO set through both tools: the same
    JPEG files, byte for byte."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from tools import browse_dataset as j_browse
    from sipmask_tpu_torch.tools import browse_dataset
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    ann, imgs = make_dataset(str(tmp_path / "set"), sizes=[(96, 80)],
                             repeat=2, min_objs=2, max_objs=4, seed=3)
    args = ["sipmask_r50_fpn_gn_1x", "--ann", ann, "--img-prefix", imgs,
            "--num", "2"]
    _tf32_on()
    mine = browse_dataset.main(args + ["--out-dir", str(tmp_path / "a")])
    assert _tf32_off()
    monkeypatch.setattr(sys, "argv", ["browse_dataset.py"] + args
                        + ["--out-dir", str(tmp_path / "b")])
    j_browse.main()
    assert len(mine) == 2
    for p in mine:
        with open(p, "rb") as a, open(
                tmp_path / "b" / os.path.basename(p), "rb") as b:
            assert a.read() == b.read(), p
