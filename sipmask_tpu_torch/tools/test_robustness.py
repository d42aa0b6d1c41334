"""Corruption robustness of a preset on a COCO-format set (the JAX
package's ``tools/test_robustness.py``): COCO AP on the clean images and
under each corruption at each severity, with mPC (the mean AP under
corruption) and rPC (mPC over the clean AP):

    python -m sipmask_tpu_torch.tools.test_robustness sipmask_r50_fpn_gn_1x \\
        WORK_DIR/epoch_12.pth --ann ANN.json --img-prefix IMAGES \\
        --corruptions gaussian_noise fog --severities 1 3 5

The corruptions are ``data/corruptions.py`` (the JAX package's bytes); the
table, {"clean": {"0": {metric: AP}}, name: {severity: {metric: AP}}},
is written to ``--out`` as the JAX tool writes it. The JAX tool's
arguments and ``--device`` (``cuda`` by default). Without a checkpoint the
model keeps its random init.
"""

from __future__ import annotations

import argparse
import json


class CorruptedDataset:
    """Dataset proxy applying one corruption to every loaded image
    (severity 0: the clean image)."""

    def __init__(self, base, name, severity):
        self._base = base
        self._name = name
        self._severity = severity

    def __getattr__(self, k):
        return getattr(self._base, k)

    def __len__(self):
        return len(self._base)

    def load_image(self, idx):
        from ..data.corruptions import corrupt
        img = self._base.load_image(idx)
        if self._severity == 0:
            return img
        return corrupt(img, self._name, self._severity)


def summarize(table, corruptions, severities):
    """{metric: (clean AP, mPC, rPC)} of a robustness table."""
    out = {}
    for metric in ("bbox", "segm"):
        clean = table["clean"][0][metric]
        vals = [table[c][s][metric] for c in corruptions for s in severities]
        mpc = sum(vals) / max(len(vals), 1)
        out[metric] = (clean, mpc, mpc / max(clean, 1e-9))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Corruption robustness.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--corruptions", nargs="*", default=None,
                    help="default: the benchmark 15")
    ap.add_argument("--severities", type=int, nargs="*",
                    default=[1, 2, 3, 4, 5])
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--out", default="robustness.json")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..apis.inference import init_detector
    from ..apis.test import evaluate_coco, run_inference
    from ..config import apply_overrides, get_config
    from ..data.coco import CocoDataset
    from ..data.corruptions import CORRUPTIONS
    from ..utils.checkpoint import load_weights
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    det = init_detector(cfg, args.device)
    if args.checkpoint:
        load_weights(args.checkpoint, det.model)
    dataset = CocoDataset(args.ann, args.img_prefix, test_mode=True)
    if args.max_images:
        dataset.images = dataset.images[:args.max_images]
        dataset.anns = dataset.anns[:args.max_images]

    corruptions = args.corruptions or sorted(CORRUPTIONS)
    table = {}

    def run(name, severity):
        ds = CorruptedDataset(dataset, name, severity)
        results = run_inference(det, ds, batch_size=args.batch_size,
                                progress=False)
        stats = evaluate_coco(results, args.ann)
        return {k: v["AP"] for k, v in stats.items()}

    print("== clean ==")
    table["clean"] = {0: run(corruptions[0], 0)}
    for name in corruptions:
        table[name] = {}
        for sev in args.severities:
            print(f"== {name} severity {sev} ==")
            table[name][sev] = run(name, sev)

    # aggregate: mPC = mean AP over corruptions x severities; rPC = mPC/clean
    for metric, (clean, mpc, rpc) in summarize(
            table, corruptions, args.severities).items():
        print(f"{metric}: clean AP {clean:.4f}  mPC {mpc:.4f}  "
              f"rPC {rpc:.4f}")

    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)
    print(f"wrote {args.out}")
    return table


if __name__ == "__main__":
    main()
