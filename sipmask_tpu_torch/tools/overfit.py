"""The overfit proofs of the JAX package (``ARTIFACTS/overfit_r5.md`` and
``ARTIFACTS/overfit_pp_r5.md``) through the port's CLIs on one device:

    python -m sipmask_tpu_torch.tools.overfit --out-dir build/overfit

writes the two-class disc / slab set (8 images of 256x256, seed 0) with
``tools/synth_coco.py --shapes``, then for each leg runs ``tools/train.py``
for 800 steps and ``tools/test.py`` on its last checkpoint, each as its own
process with the protocol's flags:

- ``flagship``: ``sipmask_r50_fpn_gn_1x`` at seed 0;
- ``rescoring``: the same with ``model.head.rescoring=True`` at seed 1.

Both legs checkpoint every 200 epochs (1 step an epoch); the train log, the
results and each command's output land in ``--out-dir``. It prints the
card's name and power limit, each command, each leg's wall times, its loss
table at the protocol's steps and its bbox and segm AP, and ends with one
JSON line of the APs and walls.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIG = "sipmask_r50_fpn_gn_1x"
PROTOCOL = ["data.fixed_size=(256,256)", "data.keep_ratio=False",
            "data.flip_ratio=0.0", "data.max_gts=8",
            "train.imgs_per_device=8", "train.optim.lr=0.005",
            "train.optim.warmup=linear", "train.optim.warmup_iters=100",
            "train.optim.warmup_ratio=0.1", "train.optim.lr_steps=(600,720)",
            "train.optim.total_epochs=800",
            "train.checkpoint_interval_epochs=200",
            "model.head.num_classes=2"]
TEST = ["data.fixed_size=(256,256)", "data.keep_ratio=False",
        "model.head.num_classes=2"]
STEPS = 800
# leg: (seed, extra options, the loss columns and steps of its table)
LEGS = {
    "flagship": (0, [], ("loss_cls", "loss_bbox", "loss_mask",
                         "loss_total"),
                 (50, 100, 200, 300, 400, 500, 600, 700, 800)),
    "rescoring": (1, ["model.head.rescoring=True"],
                  ("loss_cls", "loss_mask", "loss_iou", "loss_total"),
                  (50, 100, 300, 500, 800)),
}


def run(cmd, log_path):
    """Run ``python -m`` cmd, its output into log_path; wall seconds."""
    full = [sys.executable, "-m"] + cmd
    print("$ python " + " ".join(f'"{a}"' if "(" in a else a
                                 for a in full[1:]), flush=True)
    t0 = time.perf_counter()
    with open(log_path, "w") as f:
        subprocess.run(full, stdout=f, stderr=subprocess.STDOUT, check=True)
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out-dir", default="build/overfit")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = args.out_dir
    os.makedirs(out, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    data = os.path.join(out, "synth")
    ann, imgs = os.path.join(data, "ann.json"), os.path.join(data, "imgs")
    run(["sipmask_tpu_torch.tools.synth_coco", data, "--shapes",
         "--num-images", "8", "--size", "256", "--seed", "0"],
        os.path.join(out, "synth.txt"))
    summary = {}
    for leg, (seed, extra, cols, steps) in LEGS.items():
        wd = os.path.join(out, f"wd_{leg}")
        train_s = run(["sipmask_tpu_torch.tools.train", CONFIG, "--ann", ann,
                       "--img-prefix", imgs, "--work-dir", wd,
                       "--max-steps", str(STEPS), "--no-resume", "--seed",
                       str(seed), "--device", args.device, "--cfg-options",
                       *PROTOCOL, *extra],
                      os.path.join(out, f"{leg}_train.txt"))
        test_log = os.path.join(out, f"{leg}_test.txt")
        test_s = run(["sipmask_tpu_torch.tools.test", CONFIG,
                      os.path.join(wd, f"epoch_{STEPS}.pth"), "--ann", ann,
                      "--img-prefix", imgs, "--out",
                      os.path.join(out, f"{leg}_results.json"), "--device",
                      args.device, "--cfg-options", *TEST, *extra],
                     test_log)
        with open(os.path.join(wd, "train.log.json")) as f:
            rows = {r["step"]: r for r in map(json.loads, f)
                    if "loss_total" in r}
        print(f"{leg}: train {train_s:.1f} s, test {test_s:.1f} s")
        print("| step | " + " | ".join(cols) + " |")
        for s in steps:
            print(f"| {s} | " + " | ".join(f"{rows[s][c]:.4f}" for c in cols)
                  + " |")
        aps = {}
        with open(test_log) as f:
            for line in f:
                parts = line.split()
                if len(parts) == 4 and parts[1] in ("AP", "AP50", "AP75",
                                                    "AR"):
                    aps[f"{parts[0]}_{parts[1]}"] = float(parts[3])
        print(f"{leg}: " + ", ".join(f"{k} {v:.4f}" for k, v in aps.items()),
              flush=True)
        summary[leg] = dict(aps, train_s=round(train_s, 1),
                            test_s=round(test_s, 1))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
