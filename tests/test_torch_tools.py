"""The port's remaining CLIs against the JAX package's tools on the CPU:
``test_robustness`` (its table against one computed from the port's
drivers over images corrupted by the JAX package's ``corrupt``), the
``torch.export`` round trip of the real-time preset (against the live
graph and the JAX tool's exported outputs on the same weights),
``get_flops`` (the JAX tool's parameter counts; FLOPs against XLA's),
``coco_error_analysis`` and ``analyze_logs cal_train_time`` (the JAX
tools' printed lines), ``publish_model``, ``profile_step``, and TF32 left
off by every CLI. At golden's shrink on a 4-image synthetic set, one
torch thread."""

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from _torch_parity import bumped_state_dict
from sipmask_tpu_torch.config import apply_overrides, get_config

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
          "model.head.feat_channels=32", "model.head.stacked_convs=2",
          "data.img_scale=(160,128)"]


class _Stop(Exception):
    pass


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_off():
    return not (torch.backends.cudnn.allow_tf32
                or torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A 4-image set, bumped weights saved as a checkpoint file and the
    port's results on the set."""
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.apis.test import results_to_json, run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    out = tmp_path_factory.mktemp("tools")
    ann, imgs = make_dataset(str(out / "set"),
                             sizes=((160, 120), (150, 100)), repeat=2,
                             min_objs=3, max_objs=6, seed=2)
    cfg = apply_overrides(get_config("sipmask_r50_fpn_gn_1x"), SHRINK)
    det = init_detector(cfg, "cpu")
    sd = bumped_state_dict(det.model)
    det.model.load_state_dict(sd)
    ckpt = str(out / "bumped.pth")
    torch.save(dict(state_dict=sd, optimizer={}, step=6,
                    meta=dict(config=cfg.name)), ckpt)
    results = run_inference(det, CocoDataset(ann, imgs, test_mode=True),
                            progress=False)
    res_file = str(out / "results.json")
    with open(res_file, "w") as f:
        json.dump(results_to_json(results), f)
    return dict(ann=ann, imgs=imgs, cfg=cfg, det=det, sd=sd, ckpt=ckpt,
                results=res_file, out=out)


def test_robustness_table_is_the_drivers_over_the_jax_corruptions(setup,
                                                                  tmp_path):
    from sipmask_tpu.data.corruptions import corrupt as j_corrupt
    from sipmask_tpu_torch.apis.test import evaluate_coco, run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.tools import test_robustness as tr
    names, sevs = ["gaussian_noise", "fog"], [1, 5]
    out = str(tmp_path / "rob.json")
    _tf32_on()
    table = tr.main(["sipmask_r50_fpn_gn_1x", setup["ckpt"], "--ann",
                     setup["ann"], "--img-prefix", setup["imgs"],
                     "--corruptions", *names, "--severities", "1", "5",
                     "--out", out, "--device", "cpu", "--cfg-options",
                     *SHRINK])
    assert _tf32_off()
    with open(out) as f:
        saved = json.load(f)
    # the JAX tool's layout: json's string keys for the severities
    assert list(saved) == ["clean", *names]
    assert list(saved["clean"]) == ["0"]
    assert all(list(saved[n]) == ["1", "5"] for n in names)
    assert all(sorted(v) == ["bbox", "segm"] for n in saved
               for v in saved[n].values())

    class JaxCorrupted(tr.CorruptedDataset):
        def load_image(self, idx):
            img = self._base.load_image(idx)
            return img if self._severity == 0 else j_corrupt(
                img, self._name, self._severity)
    ds = CocoDataset(setup["ann"], setup["imgs"], test_mode=True)

    def run(name, sev):
        res = run_inference(setup["det"], JaxCorrupted(ds, name, sev),
                            progress=False)
        return {k: v["AP"] for k, v in evaluate_coco(res,
                                                     setup["ann"]).items()}
    want = {"clean": {0: run(names[0], 0)}}
    for n in names:
        want[n] = {s: run(n, s) for s in sevs}
    assert table == want
    assert tr.summarize(table, names, sevs) == tr.summarize(want, names,
                                                            sevs)
    assert want["clean"][0]["bbox"] > 0


def _rt_cfg():
    return apply_overrides(get_config("sipmask_r50_fpn_ssd_6x"),
                           SHRINK[:3] + ["model.test.score_thr=0.02"])


def test_export_round_trip_and_the_jax_tools_outputs(tmp_path):
    """The real-time preset (forward, fast NMS and the mask assembly in the
    program) at 128x160: saved and loaded, its outputs equal the live
    graph's (within 1e-6 of each output's max), and the JAX tool's exported
    outputs on the same weights within test_torch_slice's decode bounds."""
    import jax
    from tools.export import export_inference as j_export
    from sipmask_tpu.config import apply_overrides as j_apply
    from sipmask_tpu.config import get_config as j_get
    from sipmask_tpu_torch.tools import export as ex
    from _torch_parity import jax_variables
    cfg = _rt_cfg()
    exported, infer, args = ex.export_inference(cfg, shape=(128, 160),
                                                device="cpu")
    sd = bumped_state_dict(infer.model)
    infer.model.load_state_dict(sd)
    # the program holds the weights it was traced with: trace again
    exported = torch.export.export(
        ex.InferenceGraph(infer.model, cfg, True).eval(), args)
    targets = {str(n.target) for n in exported.graph.nodes}
    assert {"sipmask.deform_im2col.default",
            "sipmask.assemble_masks.default"} <= targets
    path = str(tmp_path / "p.pt2")
    torch.export.save(exported, path)
    got = ex.run_exported(torch.export.load(path), cfg, infer.model, *args)
    live = infer(*args)
    assert live["valid"].sum() > 0
    for k, v in live.items():
        scale = max(float(v.float().abs().max()), 1e-12)
        assert float((got[k].float() - v.float()).abs().max()) <= \
            1e-6 * scale, k
    jcfg = j_apply(j_get("sipmask_r50_fpn_ssd_6x"),
                   SHRINK[:3] + ["model.test.score_thr=0.02"])
    _, j_infer, j_args = j_export(jcfg, shape=(128, 160), batch=1)
    np.testing.assert_array_equal(
        np.asarray(j_args[1]).transpose(0, 3, 1, 2), args[0].numpy())
    want = jax.tree_util.tree_map(np.asarray, jax.jit(j_infer)(
        jax_variables(sd), *j_args[1:]))
    v = want["valid"]
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_array_equal(got["labels"].numpy()[v],
                                  want["labels"][v])
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["masks"].numpy(), want["masks"], rtol=0,
                               atol=1e-4)


def test_export_cli_checks_its_round_trip(tmp_path, capsys):
    """The CLI on the flagship (hard NMS: the program holds the forward,
    the decode runs after it) at a shrink."""
    from sipmask_tpu_torch.tools import export as ex
    _tf32_on()
    loaded, diffs = ex.main(["sipmask_r50_fpn_gn_1x", "--shape", "64", "96",
                             "--out", str(tmp_path), "--check", "--device",
                             "cpu", "--cfg-options", *SHRINK])
    assert _tf32_off()
    assert os.path.exists(tmp_path / "sipmask.pt2")
    assert os.path.exists(tmp_path / "weights.pth")
    assert diffs and max(diffs.values()) == 0.0
    assert "sipmask.gn_relu.default" in {str(n.target)
                                         for n in loaded.graph.nodes}


@pytest.mark.parametrize("preset", ["sipmask_r50_fpn_gn_1x",
                                    "sipmask_r50_fpn_ssd_6x",
                                    "sipmask_vis_r50"])
def test_get_flops_counts_the_jax_tools_params(preset):
    """The count of the JAX tool's params tree, exactly (its model.init at
    the full width)."""
    import jax
    import jax.numpy as jnp
    from sipmask_tpu.config import get_config as j_get
    from sipmask_tpu.models import build_model as j_build
    from sipmask_tpu_torch.models.detector import build_model
    from sipmask_tpu_torch.tools.get_flops import count_params
    jm = j_build(j_get(preset).model)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 64, 64, 3), jnp.float32))
    want = sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(v["params"]))
    cfg = get_config(preset)
    assert count_params(build_model(cfg.model), cfg) == want


def test_get_flops_within_its_bound_of_xla(capsys):
    """At the shrink, 128x160: FlopCounterMode's count (convolutions,
    matrix products, K1's taps and K6's products; the model routed through
    the custom ops) against XLA's cost_analysis of the JAX forward, which
    also counts elementwise work but counts the convolutions after its own
    rewrites: within 10% of it (1.050 of it seen)."""
    import jax
    import jax.numpy as jnp
    from sipmask_tpu.config import apply_overrides as j_apply
    from sipmask_tpu.config import get_config as j_get
    from sipmask_tpu.models import build_model as j_build
    from sipmask_tpu_torch.tools import get_flops
    _tf32_on()
    n_params, flops = get_flops.main(["sipmask_r50_fpn_gn_1x", "--shape",
                                      "128", "160", "--device", "cpu",
                                      "--cfg-options", *SHRINK])
    assert _tf32_off()
    assert "forward flops:" in capsys.readouterr().out
    jm = j_build(j_apply(j_get("sipmask_r50_fpn_gn_1x"), SHRINK).model)
    x = jnp.zeros((1, 128, 160, 3), jnp.float32)
    v = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    cost = jax.jit(jm.apply).lower(v, x).compile().cost_analysis()
    xla = cost["flops"] if isinstance(cost, dict) else cost[0]["flops"]
    assert 0.9 * xla <= flops <= 1.1 * xla, (flops, xla)


def test_custom_ops_pass_opcheck():
    """``torch.library.opcheck`` on each kernel's custom op at a small
    shape: its schema, its fake (the output's shape, dtype and strides
    against the real one's) and its dispatch under AOT."""
    import sipmask_tpu_torch.ops.custom  # noqa: F401  (registers the ops)
    g = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g)
    ops = torch.ops.sipmask
    boxes = torch.tensor([[[1.0, 2.0, 9.0, 10.0]] * 7])
    for op, args in (
            (ops.deform_im2col.default,
             (randn(1, 8, 5, 6), randn(1, 18, 5, 6), 3, 3, 1, 1, 1, 1)),
            (ops.gn_relu.default,
             (randn(2, 64, 4, 4), randn(64), randn(64), 32, 1e-5, True)),
            (ops.deform_rows.default,
             (randn(2, 30, 8), torch.rand(2, 9, 30, 2, generator=g) * 5, 5,
              6)),
            (ops.assemble_masks.default,
             (randn(1, 12, 16, 32), randn(1, 7, 128), boxes))):
        torch.library.opcheck(op, args)


def _printed(fn, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_coco_error_analysis_prints_the_jax_tools_numbers(setup,
                                                          monkeypatch):
    from tools import coco_error_analysis as j_tool
    from sipmask_tpu_torch.tools import coco_error_analysis as tool
    args = [setup["results"], "--ann", setup["ann"]]
    _tf32_on()
    got = _printed(tool.main, args)
    assert _tf32_off()
    monkeypatch.setattr(sys, "argv", ["coco_error_analysis.py"] + args)
    want = _printed(lambda _: j_tool.main(), None)
    assert "error shares" in got
    assert got == want


def test_analyze_logs_cal_train_time_prints_the_jax_tools_lines(
        tmp_path, monkeypatch):
    from tools import analyze_logs as j_tool
    from sipmask_tpu_torch.tools import analyze_logs as tool
    from sipmask_tpu_torch.utils.logging import MetricLogger
    log = str(tmp_path / "train.log.json")
    logger = MetricLogger(log)
    for step in range(1, 6):
        logger.update(loss_total=3.0 / step, loss_mask=0.5 / step,
                      grad_norm=1.5)
        logger.log(step, total_steps=5, lr=0.01)
    logger.update(loss_total=0.4)
    logger.log(6, lr=0.01)
    _tf32_on()
    got = _printed(tool.main, ["cal_train_time", log])
    assert _tf32_off()
    monkeypatch.setattr(sys, "argv", ["analyze_logs.py", "cal_train_time",
                                      log])
    want = _printed(lambda _: j_tool.main(), None)
    assert "final loss_total" in got and got == want
    # plot_curve imports matplotlib when it runs, and names it if missing
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(SystemExit, match="matplotlib"):
        tool.main(["plot_curve", log, "--out", str(tmp_path / "c.png")])


def test_publish_model_hash_and_reload(setup, tmp_path):
    from sipmask_tpu_torch.apis.inference import (inference_detector,
                                                  init_detector)
    from sipmask_tpu_torch.tools import publish_model
    from sipmask_tpu_torch.utils.checkpoint import load_weights
    _tf32_on()
    a = publish_model.main([setup["ckpt"], str(tmp_path / "a" / "m")])
    assert _tf32_off()
    b = publish_model.main([setup["ckpt"], str(tmp_path / "b" / "m")])
    assert os.path.basename(a) == os.path.basename(b)
    sha8 = os.path.basename(a).rsplit("-", 1)[1]
    assert len(sha8) == 8
    with open(os.path.join(a, "meta.json")) as f:
        meta = json.load(f)
    assert meta["sha256_8"] == sha8 and meta["config"] == setup["cfg"].name
    pub = torch.load(os.path.join(a, "model.pth"), weights_only=False)
    assert set(pub) == {"state_dict"}
    sd = dict(setup["sd"])
    sd["bbox_head.fcos_cls.bias"] = sd["bbox_head.fcos_cls.bias"] + 1e-3
    other = str(tmp_path / "other.pth")
    torch.save(sd, other)
    c = publish_model.main([other, str(tmp_path / "c" / "m")])
    assert os.path.basename(c) != os.path.basename(a)
    det = init_detector(setup["cfg"], "cpu")
    load_weights(os.path.join(a, "model.pth"), det.model)
    img = (np.random.RandomState(1).rand(120, 160, 3) * 255).astype(np.uint8)
    want, got = (inference_detector(setup["det"], img),
                 inference_detector(det, img))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_profile_step_on_the_cpu(tmp_path):
    from sipmask_tpu_torch.tools import profile_step
    out = str(tmp_path / "p.json")
    _tf32_on()
    res = profile_step.main(["sipmask_r50_fpn_gn_1x", "--mode", "infer",
                             "--batch", "1", "--shape", "64", "96",
                             "--steps", "1", "--dtype", "float32",
                             "--json-out", out, "--device", "cpu",
                             "--cfg-options", *SHRINK])
    assert _tf32_off()
    with open(out) as f:
        saved = json.load(f)
    assert saved["ops"] and saved["hw"] == [64, 96]
    assert res["ops"][0]["ms"] >= res["ops"][-1]["ms"]
    calls = {r["span"]: r["calls"] for r in saved["spans"]}
    assert calls["sipmask.infer.forward"] == calls["sipmask.infer.decode"] \
        == 1
    assert calls["sipmask.K4a"] > 0 and calls["sipmask.K6"] == 1


@pytest.mark.parametrize("cli", ["train", "test", "test_video", "overfit"])
def test_the_older_clis_leave_tf32_off(cli, monkeypatch, tmp_path):
    """Each CLI turns TF32 off before it builds anything (here stopped
    there)."""
    import importlib
    from sipmask_tpu_torch.apis import inference, train
    mod = importlib.import_module(f"sipmask_tpu_torch.tools.{cli}")

    def stop(*a, **k):
        raise _Stop
    monkeypatch.setattr(train, "train_detector", stop)
    monkeypatch.setattr(inference, "init_detector", stop)
    argv = {"train": ["sipmask_r50_fpn_gn_1x", "--ann", "a", "--img-prefix",
                      "i", "--work-dir", str(tmp_path)],
            "test": ["sipmask_r50_fpn_gn_1x", "--ann", "a", "--img-prefix",
                     "i"],
            "test_video": ["sipmask_vis_r50", "--ann", "a", "--img-prefix",
                           "i"],
            "overfit": ["--out-dir", str(tmp_path), "--legs", "flagship"]}
    if cli == "overfit":
        monkeypatch.setattr(mod, "run", stop)
    _tf32_on()
    with pytest.raises(_Stop):
        mod.main(argv[cli] + ["--device", "cpu"])
    assert _tf32_off()
