"""The overfit proofs of the JAX package (``ARTIFACTS/overfit_r5.md``,
``ARTIFACTS/overfit_pp_r5.md`` and ``ARTIFACTS/overfit_vis_r5.md``) through
the port's CLIs on one device:

    python -m sipmask_tpu_torch.tools.overfit --out-dir build/overfit \\
        [--legs flagship rescoring vis flagship_bf16 rescoring_bf16 \
                vis_bf16]

Each leg writes its synthetic set, then runs ``tools/train.py`` and the
leg's test CLI on a checkpoint, each as its own process with the
protocol's flags:

- ``flagship``: ``sipmask_r50_fpn_gn_1x`` at seed 0, on the two-class disc
  / slab set (8 images of 256x256, seed 0, ``tools/synth_coco.py
  --shapes``), 800 steps, ``tools/test.py`` on the last checkpoint;
- ``rescoring``: the same with ``model.head.rescoring=True`` at seed 1;
- ``flagship_bf16``, ``rescoring_bf16``, ``vis_bf16``: those legs with
  ``model.compute_dtype=bfloat16`` in training and test (not among the
  default legs: the JAX artifacts hold no bf16 run);
- ``vis``: ``sipmask_vis_r50`` at seed 1 on ``tools/synth_ytvis.py``'s 4
  videos of 4 frames at 256x256 (seed 0), ``max_gts`` 4, 1800 steps (2 an
  epoch), ``tools/test_video.py --eval`` on epoch 900.

The image legs checkpoint every 200 epochs (1 step an epoch), the VIS leg
every 300 (the JAX protocol's default of every epoch would write 900
checkpoints; training is the same). The train logs, the results and each
command's output land in ``--out-dir``. It prints the card's name and power
limit, each command, each leg's wall times, its loss table at the
protocol's steps and its APs, and ends with one JSON line of the APs and
walls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

IMAGE_TRAIN = ["data.fixed_size=(256,256)", "data.keep_ratio=False",
               "data.flip_ratio=0.0", "data.max_gts=8",
               "train.imgs_per_device=8", "train.optim.lr=0.005",
               "train.optim.warmup=linear", "train.optim.warmup_iters=100",
               "train.optim.warmup_ratio=0.1",
               "train.optim.lr_steps=(600,720)",
               "train.optim.total_epochs=800",
               "train.checkpoint_interval_epochs=200",
               "model.head.num_classes=2"]
IMAGE_TEST = ["data.fixed_size=(256,256)", "data.keep_ratio=False",
              "model.head.num_classes=2"]
VIS_TRAIN = ["data.fixed_size=(256,256)", "data.keep_ratio=False",
             "data.flip_ratio=0.0", "data.max_gts=4",
             "train.imgs_per_device=8", "train.optim.lr=0.005",
             "train.optim.warmup=linear", "train.optim.warmup_iters=100",
             "train.optim.warmup_ratio=0.1",
             "train.optim.lr_steps=(1650,1725)",
             "train.optim.total_epochs=1800",
             "train.checkpoint_interval_epochs=300",
             "model.head.num_classes=2"]
VIS_TEST = ["model.head.num_classes=2", "data.fixed_size=(256,256)",
            "data.keep_ratio=False"]
SYNTH = {
    "coco": ["sipmask_tpu_torch.tools.synth_coco", "--shapes",
             "--num-images", "8", "--size", "256", "--seed", "0"],
    "ytvis": ["sipmask_tpu_torch.tools.synth_ytvis", "--num-videos", "4",
              "--frames", "4", "--size", "256", "--seed", "0"],
}
# leg: config, data set, seed, train options, test CLI and options, steps,
# checkpoint epoch tested, the loss columns and steps of its table
LEGS = {
    "flagship": dict(
        config="sipmask_r50_fpn_gn_1x", data="coco", seed=0,
        train=IMAGE_TRAIN, test=("test", IMAGE_TEST), steps=800, epoch=800,
        cols=("loss_cls", "loss_bbox", "loss_mask", "loss_total"),
        at=(50, 100, 200, 300, 400, 500, 600, 700, 800)),
    "rescoring": dict(
        config="sipmask_r50_fpn_gn_1x", data="coco", seed=1,
        train=IMAGE_TRAIN + ["model.head.rescoring=True"],
        test=("test", IMAGE_TEST + ["model.head.rescoring=True"]),
        steps=800, epoch=800,
        cols=("loss_cls", "loss_mask", "loss_iou", "loss_total"),
        at=(50, 100, 300, 500, 800)),
    "vis": dict(
        config="sipmask_vis_r50", data="ytvis", seed=1, train=VIS_TRAIN,
        test=("test_video", VIS_TEST), steps=1800, epoch=900,
        cols=("loss_cls", "loss_bbox", "loss_mask", "loss_match",
              "match_acc"),
        at=(50, 100, 400, 600, 900, 1200, 1800)),
}
BF16 = ["model.compute_dtype=bfloat16"]
LEGS.update({f"{leg}_bf16": dict(
    LEGS[leg], train=LEGS[leg]["train"] + BF16,
    test=(LEGS[leg]["test"][0], LEGS[leg]["test"][1] + BF16))
    for leg in ("flagship", "rescoring", "vis")})


def run(cmd, log_path):
    """Run ``python -m`` cmd, its output into log_path; wall seconds."""
    full = [sys.executable, "-m"] + cmd
    print("$ python " + " ".join(f'"{a}"' if "(" in a else a
                                 for a in full[1:]), flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        subprocess.run(full, stdout=f, stderr=subprocess.STDOUT, check=True)
    return time.perf_counter() - t0


def _aps(test_log):
    """The APs a test CLI printed: COCO's "bbox AP = x" style lines and
    YTVIS's "ytvis AP = x"."""
    aps = {}
    with open(test_log) as f:
        for line in f:
            parts = line.split()
            if len(parts) == 4 and parts[1] in ("AP", "AP50", "AP75", "AR"):
                aps[f"{parts[0]}_{parts[1]}"] = float(parts[3])
    return aps


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="build/overfit")
    ap.add_argument("--legs", nargs="+", choices=list(LEGS),
                    default=["flagship", "rescoring", "vis"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out_dir
    os.makedirs(out, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    sets = {}
    summary = {}
    for leg in args.legs:
        c = LEGS[leg]
        if c["data"] not in sets:
            data = os.path.join(out, f"synth_{c['data']}")
            run(SYNTH[c["data"]][:1] + [data] + SYNTH[c["data"]][1:],
                os.path.join(out, f"synth_{c['data']}.txt"))
            sets[c["data"]] = (os.path.join(data, "ann.json"),
                               os.path.join(data, "imgs"))
        ann, imgs = sets[c["data"]]
        wd = os.path.join(out, f"wd_{leg}")
        train_s = run(["sipmask_tpu_torch.tools.train", c["config"], "--ann",
                       ann, "--img-prefix", imgs, "--work-dir", wd,
                       "--max-steps", str(c["steps"]), "--no-resume",
                       "--seed", str(c["seed"]), "--device", args.device,
                       "--cfg-options", *c["train"]],
                      os.path.join(out, f"{leg}_train.txt"))
        test_log = os.path.join(out, f"{leg}_test.txt")
        cli, opts = c["test"]
        test_s = run([f"sipmask_tpu_torch.tools.{cli}", c["config"],
                      os.path.join(wd, f"epoch_{c['epoch']}.pth"), "--ann",
                      ann, "--img-prefix", imgs, "--out",
                      os.path.join(out, f"{leg}_results.json"), "--device",
                      args.device]
                     + (["--eval"] if cli == "test_video" else [])
                     + ["--cfg-options", *opts], test_log)
        with open(os.path.join(wd, "train.log.json")) as f:
            rows = {r["step"]: r for r in map(json.loads, f)
                    if "loss_total" in r}
        print(f"{leg}: train {train_s:.1f} s, test {test_s:.1f} s")
        print("| step | " + " | ".join(c["cols"]) + " |")
        for st in c["at"]:
            print(f"| {st} | " + " | ".join(f"{rows[st][k]:.4f}"
                                            for k in c["cols"]) + " |")
        aps = _aps(test_log)
        print(f"{leg}: " + ", ".join(f"{k} {v:.4f}" for k, v in aps.items()),
              flush=True)
        summary[leg] = dict(aps, train_s=round(train_s, 1),
                            test_s=round(test_s, 1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
