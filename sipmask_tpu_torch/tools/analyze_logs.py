"""Training-log analysis over the JSON lines that ``utils/logging.py``
writes (``train.log.json``), the JAX package's ``tools/analyze_logs.py``:

    python -m sipmask_tpu_torch.tools.analyze_logs cal_train_time LOG
    python -m sipmask_tpu_torch.tools.analyze_logs plot_curve LOG \\
        --keys loss_total loss_mask --out curve.png

``plot_curve`` needs matplotlib, imported when it runs.
"""

from __future__ import annotations

import argparse
import json


def load(path):
    recs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                recs.append(json.loads(line))
    return recs


def plot_curve(recs, keys, out):
    try:
        import matplotlib
    except ImportError as e:
        raise SystemExit(f"plot_curve needs matplotlib ({e})")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    for k in keys:
        xs = [r["step"] for r in recs if k in r]
        ys = [r[k] for r in recs if k in r]
        plt.plot(xs, ys, label=k)
    plt.xlabel("step")
    plt.legend()
    plt.savefig(out, dpi=120)
    print(f"wrote {out}")


def cal_train_time(recs):
    steps = [r["step"] for r in recs]
    if len(steps) >= 2:
        print(f"{len(steps)} log records, steps {steps[0]}..{steps[-1]}")
    for k in recs[-1]:
        if k.startswith("loss"):
            print(f"  final {k}: {recs[-1][k]:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Analyse a train log.")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("plot_curve")
    p1.add_argument("log")
    p1.add_argument("--keys", nargs="+", default=["loss_total"])
    p1.add_argument("--out", default="curve.png")
    p2 = sub.add_parser("cal_train_time")
    p2.add_argument("log")
    args = ap.parse_args(argv)

    from ..utils.precision import no_tf32
    no_tf32()
    recs = load(args.log)
    if args.cmd == "plot_curve":
        plot_curve(recs, args.keys, args.out)
    else:
        cal_train_time(recs)


if __name__ == "__main__":
    main()
