"""The port's data parallelism (``sipmask_tpu_torch.parallel``) on the CPU:
ranks are processes of a gloo group (tests/_torch_dist_worker.py), each on
one torch thread with its shard of a global batch, against the JAX
package's losses on the global batch and one port process that runs it
whole.

- The train step at golden's shrink (FPN and head 32 wide, stacked_convs
  2, max_pos 8) on ``demo_batch(8, 64, 64, max_gts=8, seed=5)`` for the
  flagship and the SipMask-benchmark fork, and on ``vis_pair_batch`` for
  SipMask-VIS, from a JAX init: 2 ranks x 4 images, and the flagship on 4
  ranks x 2 images.
- The unshrunk flagship (R50, FPN 256, stacked_convs 4, max_pos 16) at
  64x64 on 2 ranks x 1 image, as ``__graft_entry__.dryrun_multichip`` runs
  it, and SipMask++ (R50 with its DCN stages, 256x256) on 2 ranks x 1
  image: ``loss_iou`` and the rescoring weights' global sum.
- A checkpoint written by rank 0 of 2, restored into other weights and
  stepped once, against 3 unbroken steps; the file restores in one
  process.
- ``run_inference`` sharded over 2 ranks on 7 JPEG images (uneven shards,
  a padded batch), collected over the group and through part files.
- World 1: the losses and the step of a process group of one give the
  bits of no process group.
- tools/train.py --distributed and tools/test.py --dist on 2 ranks, and a
  group that cannot start or loses a rank raises.

The groups (of 1 rank, of 4, and two of 2) run once, in parallel, for the
whole file (module fixture ``runs``): rank 0 of each group holds its steps
against its own one-process run, while this process computes the JAX
package's losses.
"""

import os
import pickle
import shutil
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_worker as W
from sipmask_tpu.config import _r as j_r
from sipmask_tpu.config import get_config as j_get_config
from sipmask_tpu.models import build_model as j_build_model
from sipmask_tpu.models.loss import compute_losses as j_compute_losses
from sipmask_tpu_torch.utils.convert import params_from_jax

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6      # test_torch_train.py's port vs JAX
ONE_RTOL, ONE_ATOL = 1e-6, 1e-7        # tests/test_distributed.py:209-210
PARAM_REL = 1e-5                       # of each tensor's max |value|
GROUP_TIMEOUT = 600                    # s, a group's wall time at most

SHRINK = [("model.fpn", dict(out_channels=32)),
          ("model.head", dict(in_channels=32, feat_channels=32,
                              stacked_convs=2)),
          ("train", dict(max_pos=8))]
DEMO8 = ("demo", dict(batch_size=8, height=64, width=64, max_gts=8, seed=5))
STEP_CASES = {
    "flagship": (("sipmask_r50_fpn_gn_1x", SHRINK), DEMO8),
    "fork": (("sipmask_benchmark_r50_fpn_1x", SHRINK), DEMO8),
    "vis": (("sipmask_vis_r50", SHRINK),
            ("vis", dict(batch_size=8, height=64, width=64, max_gts=16,
                         num_classes=40, seed=5))),
}
UNSHRUNK = (("sipmask_r50_fpn_gn_1x", [("train", dict(max_pos=16))]),
            ("demo", dict(batch_size=2, height=64, width=64, max_gts=8,
                          seed=0)))
PP = (("sipmaskpp_r101_fpn_ssd_6x",
       [("model.backbone", dict(depth=50)),
        ("model.fpn", dict(out_channels=32)),
        ("model.head", dict(in_channels=32, feat_channels=32)),
        ("data", dict(fixed_size=(256, 256), train_size=(256, 256))),
        ("train", dict(max_pos=16))]),
      ("demo", dict(batch_size=2, height=256, width=256, max_gts=8, seed=7)))
EVAL_CFG = ("sipmask_r50_fpn_gn_1x",
            [("model.fpn", dict(out_channels=32)),
             ("model.head", dict(in_channels=32, feat_channels=32,
                                 stacked_convs=2, num_classes=1)),
             ("data", dict(fixed_size=(128, 128), keep_ratio=False)),
             ("model.test", dict(score_thr=0.005, nms_pre=100,
                                 max_per_img=20))])
CLI_SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
              "model.head.feat_channels=32", "model.head.stacked_convs=2",
              "data.img_scale=(160,128)", "data.max_gts=8",
              "data.num_workers=1", "train.imgs_per_device=1",
              "train.max_pos=16", "train.log_interval=1"]
VIS_SHRINK = ["model.fpn.out_channels=32", "model.head.in_channels=32",
              "model.head.feat_channels=32", "data.img_scale=(160,128)",
              "data.max_gts=6", "data.num_workers=1",
              "train.imgs_per_device=1", "train.max_pos=16",
              "train.log_interval=1"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """The ranks of one world size, each a worker process with its log."""

    def __init__(self, tmp, name, world, **cases):
        out = os.path.join(tmp, name)
        os.makedirs(out)
        spec = dict(world=world, port=_free_port(), out=out, **cases)
        path = os.path.join(out, "spec.pkl")
        with open(path, "wb") as f:
            pickle.dump(spec, f)
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.name, self.out, self.world = name, out, world
        self.logs = [os.path.join(out, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, WORKER, path, str(r)], env=env,
                    stdout=log, stderr=subprocess.STDOUT))
        self.deadline = time.monotonic() + GROUP_TIMEOUT
        self.done = False

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def wait(self):
        """Until every rank has exited 0; the first rank to fail, or the
        timeout, kills the rest and fails the test with the logs."""
        while not self.done:
            codes = [p.poll() for p in self.procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.monotonic() > self.deadline
            if failed or late:
                self.kill()
                tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n"
                                  + open(log).read()[-3000:]
                                  for r, (p, log) in
                                  enumerate(zip(self.procs, self.logs)))
                pytest.fail(f"group {self.name}: "
                            + (f"ranks {failed} failed" if failed else
                               f"timed out after {GROUP_TIMEOUT} s")
                            + "\n" + tails)
            self.done = all(c == 0 for c in codes)
            if not self.done:
                time.sleep(0.2)

    def result(self, case, rank):
        self.wait()
        return torch.load(os.path.join(self.out, f"{case}.{rank}.pt"),
                          weights_only=False)

    def results(self, case):
        return [self.result(case, r) for r in range(self.world)]


def _jax_init(cfg, batch):
    """The JAX package's init from PRNGKey(0) on the batch's first image
    (and reference frame), fcos_reg's bias set to 2.0 as
    ``dryrun_multichip`` sets it (boxes that are not points: a non-zero
    mask loss)."""
    model = j_build_model(cfg.model)
    args = [jnp.asarray(batch["images"][:1])]
    if cfg.model.head.track:
        args.append(jnp.asarray(batch["ref_images"][:1]))
    variables = jax.jit(model.init)(jax.random.PRNGKey(0), *args)
    def bump(path, leaf):
        keys = [getattr(k, "key", "") for k in path]
        return (jnp.full_like(leaf, 2.0) if keys[-2:] == ["fcos_reg", "bias"]
                else leaf)
    params = jax.tree_util.tree_map_with_path(bump, variables["params"])
    return model, {"params": params,
                   "constants": variables.get("constants", {})}


def _jax_batch(batch):
    """Port tensors -> numpy for JAX, images NCHW -> NHWC."""
    return {k: (v.permute(0, 2, 3, 1) if k in ("images", "ref_images")
                else v).numpy() for k, v in batch.items()}


def _j_cfg(spec):
    name, edits = spec
    cfg = j_get_config(name)
    for path, kw in edits:
        cfg = j_r(cfg, path, **kw)
    return cfg


def _save(tmp, name, sd):
    path = os.path.join(tmp, f"{name}.weights.pt")
    torch.save(sd, path)
    return path


def _write_eval_set(root):
    """7 JPEG images, portrait and landscape (odd: uneven shards and a
    padded batch), with no annotations."""
    import json
    from sipmask_tpu_torch.data.image_io import imwrite_jpeg
    rng = np.random.RandomState(0)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    images = []
    for i in range(7):
        h, w = (60, 80) if i % 2 else (80, 60)
        imwrite_jpeg(os.path.join(img_dir, f"{i}.jpg"),
                     rng.randint(0, 255, (h, w, 3), np.uint8))
        images.append(dict(id=i + 1, file_name=f"{i}.jpg", width=w,
                           height=h))
    ann = os.path.join(root, "ann.json")
    with open(ann, "w") as f:
        json.dump(dict(images=images, annotations=[],
                       categories=[dict(id=1, name="a")]), f)
    return ann, img_dir


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes every case's weights and data, starts the groups of world 1,
    2 and 4, and returns them with the cases (the JAX models and
    variables of the step cases beside)."""
    tmp = str(tmp_path_factory.mktemp("dist"))
    cases, jax_side = {}, {}
    for name, (cfg_spec, batch_spec) in STEP_CASES.items():
        cfg = _j_cfg(cfg_spec)
        batch = _jax_batch(W.global_batch(batch_spec))
        model, variables = _jax_init(cfg, batch)
        jax_side[name] = (cfg, model, variables, batch)
        cases[name] = dict(name=name, kind="train", cfg=cfg_spec,
                           batch=batch_spec, weights=_save(
                               tmp, name, params_from_jax(
                                   variables["params"],
                                   variables["constants"])))
    cases["unshrunk"] = dict(name="unshrunk", kind="train", cfg=UNSHRUNK[0],
                             batch=UNSHRUNK[1],
                             weights=("bumped", UNSHRUNK[0], 0))
    cases["pp"] = dict(name="pp", kind="train", cfg=PP[0], batch=PP[1],
                       weights=("pp", PP[0], PP[1]))
    work = os.path.join(tmp, "ckpt_work")
    os.makedirs(work)
    from sipmask_tpu_torch.train import make_train_step
    from sipmask_tpu_torch.utils.checkpoint import save_checkpoint
    cfg, one = W._state(cases["flagship"])
    make_train_step(one, cfg)(W.global_batch(DEMO8))
    single = os.path.join(tmp, "one_process", "step1.pth")
    save_checkpoint(single, one)
    cases["single"] = (one.step, W.summary(W.snapshot(one)))
    cases["ckpt"] = dict(cases["flagship"], name="ckpt", kind="checkpoint",
                         work_dir=work, single=single)
    ann, imgs = _write_eval_set(os.path.join(tmp, "eval"))
    cases["eval"] = dict(name="eval", kind="evaluate", cfg=EVAL_CFG,
                         ann=ann, images=imgs,
                         tmpdir=os.path.join(tmp, "collect"))
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    s_ann, s_imgs = make_dataset(os.path.join(tmp, "synth"),
                                 sizes=((160, 120), (120, 160)), repeat=2,
                                 min_objs=3, max_objs=6, seed=2)
    from sipmask_tpu_torch.tools.synth_ytvis import make_dataset as make_vis
    v_ann, v_imgs = make_vis(os.path.join(tmp, "vis"), num_videos=2,
                             frames=3, size=96, seed=3)
    cli_wd = cases["cli_wd"] = os.path.join(tmp, "cli_wd")
    vis_wd = cases["vis_wd"] = os.path.join(tmp, "vis_wd")
    after = [
        dict(name="train_cli", kind="train_cli", port=_free_port(),
             argv=["sipmask_r50_fpn_gn_1x", "--ann", s_ann, "--img-prefix",
                   s_imgs, "--work-dir", cli_wd, "--max-steps", "2",
                   "--val-ann", s_ann, "--device", "cpu", "--cfg-options",
                   *CLI_SHRINK, "model.test.score_thr=0.005"]),
        dict(name="vis_cli", kind="train_cli", port=_free_port(),
             argv=["sipmask_vis_r50", "--ann", v_ann, "--img-prefix", v_imgs,
                   "--work-dir", vis_wd, "--max-steps", "2", "--val-ann",
                   v_ann, "--device", "cpu", "--cfg-options", *VIS_SHRINK]),
        dict(name="eval_cli", kind="eval_cli", port=_free_port(),
             argv=["sipmask_r50_fpn_gn_1x", "--ann", s_ann, "--img-prefix",
                   s_imgs, "--batch-size", "1", "--device", "cpu",
                   "--eval", "bbox", "--cfg-options", *CLI_SHRINK,
                   "model.test.score_thr=0.005"])]
    w1 = [dict(cases["flagship"], name="w1_losses", kind="losses"),
          dict(cases["flagship"], name="w1_train")]
    compared = ["flagship", "fork", "vis", "unshrunk", "pp"]
    groups = dict(
        w2=Group(tmp, "w2", 2, references=compared,
                 group=[cases[k] for k in compared]),
        w2b=Group(tmp, "w2b", 2, group=[cases["ckpt"], cases["eval"]],
                  after=after),
        w4=Group(tmp, "w4", 4, references=["flagship"],
                 group=[cases["flagship"]]),
        w1=Group(tmp, "w1", 1, before=[dict(c, name=c["name"] + "_plain")
                                       for c in w1]
                 + [dict(cases["eval"], name="eval_plain")],
                 group=[dict(c, name=c["name"] + "_group") for c in w1]))
    try:
        yield groups, cases, jax_side
    finally:
        for g in groups.values():
            g.kill()
        shutil.rmtree(tmp)   # ~1 GB of weights and checkpoints


def _assert_ranks_agree(outs, what):
    """Every rank's metrics, parameters and momentum equal rank 0's (their
    digests)."""
    for r, out in enumerate(outs[1:], 1):
        assert out["metrics"] == outs[0]["metrics"], (what, r)
        for part in ("params", "momentum"):
            assert out[part] == outs[0][part], (what, r, part)


def _assert_matches_one_process(out, what):
    """The global losses within rtol 1e-6 / atol 1e-7 of one process on
    the global batch; every parameter and momentum buffer within 1e-5 of
    its max (rank 0 held them against its own one-process run)."""
    for i, (got, want) in enumerate(zip(out["metrics"],
                                        out["reference_metrics"])):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=ONE_RTOL,
                                       atol=ONE_ATOL,
                                       err_msg=f"{what} step {i} {k}")
    for part, (err, n) in out["worst"].items():
        assert err <= PARAM_REL, f"{what} {part} {n}: {err:.3e}"


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_two_rank_step_gives_the_global_batch_losses(runs, name):
    """2 ranks x 4 images: every rank's losses are the JAX package's
    ``compute_losses`` on the global batch of 8, and the losses,
    parameters and momentum after the step are one port process's on the
    global batch."""
    groups, _, jax_side = runs
    cfg, model, variables, batch = jax_side[name]
    head = cfg.model.head

    def loss_fn(v, b):
        args = [b["images"]] + ([b["ref_images"]] if head.track else [])
        return j_compute_losses(model.apply(v, *args), b, head,
                                max_pos=cfg.train.max_pos)
    want = {k: float(v) for k, v in jax.jit(loss_fn)(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}).items()}
    outs = groups["w2"].results(name)
    _assert_ranks_agree(outs, name)
    got = outs[0]["metrics"][0]
    assert got["loss_mask"] > 0
    if head.track:
        assert got["loss_match"] > 0
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=f"{name} {k} against JAX")
    _assert_matches_one_process(outs[0], name)


def test_four_ranks_match_one_process(runs):
    """The flagship on 4 ranks x 2 images of the same global batch."""
    groups, _, _ = runs
    outs = groups["w4"].results("flagship")
    _assert_ranks_agree(outs, "4 ranks")
    _assert_matches_one_process(outs[0], "4 ranks")


@pytest.mark.parametrize("name", ["unshrunk", "pp"])
def test_two_ranks_of_one_image_match_one_process(runs, name):
    """The unshrunk flagship at 64x64 and SipMask++ at 256x256, each on 2
    ranks x 1 image against one process with both: SipMask++'s loss_iou
    needs the rescoring weights' global sum."""
    groups, _, _ = runs
    outs = groups["w2"].results(name)
    _assert_ranks_agree(outs, name)
    got = outs[0]["metrics"][0]
    assert got["loss_mask"] > 0
    if name == "pp":
        assert got["loss_iou"] > 0
    _assert_matches_one_process(outs[0], name)


def test_checkpoint_round_trip_is_exact(runs):
    """Rank 0 of 2 writes the checkpoint after 2 steps; restored into other
    weights on every rank, 1 more step equals 3 unbroken steps bit for bit
    (loss, parameters, momentum); the file has the single-process keys and
    restores in one process; and one process's checkpoint restores on
    every rank with its step, parameters and momentum."""
    from sipmask_tpu_torch.train import create_train_state
    from sipmask_tpu_torch.utils.checkpoint import restore_checkpoint
    groups, cases, _ = runs
    outs = groups["w2b"].results("ckpt")
    for r, out in enumerate(outs):
        assert out["steps"] == (3, 3)
        assert out["loss_resumed"] == out["loss_straight"], r
        assert out["resumed"] == out["straight"] == outs[0]["resumed"], r
        assert out["from_one_process"] == cases["single"], r
    cfg = W.port_cfg(cases["ckpt"]["cfg"])
    state = create_train_state(cfg, "cpu", seed=1, steps_per_epoch=10)
    ckpt = torch.load(outs[0]["path"], weights_only=False)
    assert ckpt["state_dict"].keys() == state.model.state_dict().keys()
    restore_checkpoint(outs[0]["path"], state)
    assert state.step == 2


def _canon(results):
    return [{k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in sorted(r.items())} for r in results]


@pytest.mark.parametrize("transport", ["gather", "tmpdir"])
def test_sharded_run_inference_is_the_single_process_list(runs, transport):
    """7 images sharded over 2 ranks: every rank returns the same list
    through either transport, bit for bit, and it is the list of one
    process without a group (a worker process like the ranks) in its
    order: image ids, labels and RLEs bit for bit, boxes and scores within
    tests/test_torch_drivers.py's run_inference bounds (1e-3 px, 1e-6).
    The floats may differ in their last bit: on the CPU an image's scores
    depend on its position in the batch (the same image at positions 0 and
    1 of one batch gets scores one f32 unit apart, from the same logits),
    and the shards batch other images together. The part files are
    gone."""
    groups, cases, _ = runs
    case = cases["eval"]
    want = _canon(groups["w1"].result("eval_plain", 0)["gather"])
    assert len(want) > 0, "no detections at all"
    outs = groups["w2b"].results("eval")
    base = _canon(outs[0]["gather"])
    for r, out in enumerate(outs):
        for how in ("gather", "tmpdir"):
            assert _canon(out[how]) == base, (r, how)
    got = _canon(outs[0][transport])
    assert len(got) == len(want)
    unequal = {}
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys(), i
        for k in w:
            if k in ("bbox", "score", "det_score"):
                err = float(np.abs(np.subtract(g[k], w[k])).max())
                if err:
                    unequal[(i, w["image_id"], k)] = err
                assert err <= (1e-3 if k == "bbox" else 1e-6), (
                    f"result {i} (image {w['image_id']}) {k}: {g[k]} "
                    f"against one process's {w[k]}")
            else:
                assert g[k] == w[k], (i, k)
    print(f"{len(got)} results; floats not bit-equal to one process's "
          f"(result, image id, field): error {unequal}")


def test_world_one_leaves_the_numbers_alone(runs):
    """A process group of one rank: compute_losses and one step give the
    bits that no process group gives."""
    groups, _, _ = runs
    (plain,), (group,) = (groups["w1"].results("w1_losses_plain"),
                          groups["w1"].results("w1_losses_group"))
    assert plain == group
    (plain,), (group,) = (groups["w1"].results("w1_train_plain"),
                          groups["w1"].results("w1_train_group"))
    assert plain["metrics"] == group["metrics"]
    assert plain["params"] == group["params"]
    assert plain["momentum"] == group["momentum"]


def test_distributed_clis(runs):
    """tools/train.py --distributed (explicit coordinator) and
    tools/test.py --dist (torchrun's environment) on 2 ranks: the same
    weights on both ranks after 2 steps, rank 0's checkpoint (the
    weights) and train log (a line a step and the eval hook's, which
    inferred each rank's shard), and only rank 0 reports COCO stats."""
    import json
    from sipmask_tpu_torch.utils.checkpoint import latest_checkpoint
    from sipmask_tpu_torch.config import apply_overrides, get_config
    from sipmask_tpu_torch.models.detector import build_model
    groups, cases, _ = runs
    train = groups["w2b"].results("train_cli")
    assert [t["step"] for t in train] == [2, 2]
    assert train[0]["params"] == train[1]["params"]
    assert train[0]["momentum"] == train[1]["momentum"]
    wd = cases["cli_wd"]
    last = latest_checkpoint(wd)
    assert last and sorted(os.listdir(wd)) == sorted(
        ["best_checkpoint", "last_checkpoint", os.path.basename(last),
         "train.log.json"])
    saved = torch.load(last, weights_only=False)["state_dict"]
    names = dict(build_model(apply_overrides(
        get_config("sipmask_r50_fpn_gn_1x"), CLI_SHRINK).model)
        .named_parameters())
    assert W.digest({n: saved[n] for n in names}) == train[0]["params"]
    with open(os.path.join(wd, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if "loss_total" in r] == [1, 2]
    val = [r for r in lines if "val/bbox/AP" in r]
    assert len(val) == 1 and np.isfinite(val[0]["val/segm/AP"])
    stats = [out["stats"] for out in groups["w2b"].results("eval_cli")]
    assert stats[1] is None and set(stats[0]) == {"bbox"}
    assert all(np.isfinite(v) for v in stats[0]["bbox"].values())


def test_vis_train_cli_evaluates_on_rank_0(runs):
    """SipMask-VIS's tools/train.py --distributed on 2 ranks with
    --val-ann: rank 0 tracks and scores the videos while rank 1 waits at
    the host group's barrier; both end with the same weights, and the log
    holds a line a step and one evaluation."""
    import json
    groups, cases, _ = runs
    train = groups["w2b"].results("vis_cli")
    assert [t["step"] for t in train] == [2, 2]
    assert train[0]["params"] == train[1]["params"]
    with open(os.path.join(cases["vis_wd"], "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    steps = [r for r in lines if "loss_total" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss_match"]) and 0 <= r["match_acc"] <= 1
               for r in steps)
    assert len([r for r in lines if "val/segm/AP" in r]) == 1


def test_a_group_that_cannot_start_raises():
    """No torchrun environment and no coordinator; NCCL where there is
    none; a CUDA device where there is none: each raises, and no group is
    left behind (nothing goes on at world 1 or on another backend)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")}
    port = _free_port()
    code = (
        "import torch.distributed as dist\n"
        "from sipmask_tpu_torch.parallel import init_distributed\n"
        "for kw in ({'device': 'cpu'},\n"
        "           {'coordinator_address': '127.0.0.1:%d',\n"
        "            'num_processes': 1, 'process_id': 0,\n"
        "            'backend': 'nccl', 'device': 'cpu'},\n"
        "           {'coordinator_address': '127.0.0.1:%d',\n"
        "            'num_processes': 1, 'process_id': 0}):\n"
        "    try:\n"
        "        init_distributed(**kw)\n"
        "    except (RuntimeError, ValueError) as e:\n"
        "        print('raised', type(e).__name__)\n"
        "    assert not dist.is_initialized(), kw\n" % (port, port))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=os.path.dirname(HERE),
                         env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("raised") == 3, res.stdout + res.stderr


def test_a_lost_rank_fails_the_others():
    """Rank 1 of 2 exits after joining; rank 0's next global sum raises and
    its process exits non-zero, well within the group's timeout."""
    port = _free_port()
    code = (
        "import sys, torch\n"
        "from sipmask_tpu_torch.parallel import global_sum, init_distributed\n"
        "rank = int(sys.argv[1])\n"
        "init_distributed('127.0.0.1:%d', 2, rank, device='cpu')\n"
        "if rank == 1:\n"
        "    sys.exit(3)\n"
        "print(global_sum(torch.tensor(1.0)))\n" % port)
    root = os.path.dirname(HERE)
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], cwd=root,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[1].returncode == 3, outs[1]
    assert procs[0].returncode != 0, outs[0]
