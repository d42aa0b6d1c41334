"""Kernel phases of ``chip_smoke.py`` alone, for one or more checkouts in
one process on one CUDA card, in the order given (``parent . . parent``
compares two trees in turns):

    python -m sipmask_tpu_torch.tools.smoke_phases \\
        build/parent . . build/parent --phases 6 19

from the root of the checkout. Each tree's ``chip_smoke.py`` and package
are imported afresh from that tree and build its kernels under it; a
phase's lines are ``chip_smoke.py``'s own, behind a ``==== tree`` line.
The phases: 3 (K1, K4a), 6 (K2, K3a, K3b, K4b), 9 (K5, K5c, K6), 19 and
23 (the bf16 variants).
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

PHASES = {"3": "phase_kernels", "6": "phase_train_kernels",
          "9": "phase_pp_kernels", "19": "phase_bf16_kernels",
          "23": "phase_bf16_pp_kernels"}


def run_tree(tree: str, phases):
    import torch
    for name in [m for m in sys.modules
                 if m == "chip_smoke" or m.startswith("sipmask_tpu_torch")]:
        del sys.modules[name]
    root = os.path.abspath(tree)
    sys.path.insert(0, root)
    try:
        smoke = importlib.import_module("chip_smoke")
        if not os.path.abspath(smoke.__file__).startswith(root):
            raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
        smoke.log(f"==== tree {tree}")
        smoke.set_backend_flags()
        smoke.build_kernels()
        dev = torch.device("cuda", 0)
        for phase in phases:
            t0 = time.perf_counter()
            _, times, _ = getattr(smoke, PHASES[phase])(dev)
            smoke.log(f"==== tree {tree} phase {phase} "
                      f"{time.perf_counter() - t0:.1f} s: (kernel ms, plain "
                      f"ms) " + ", ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                                         for k, v in times.items()))
    finally:
        sys.path.remove(root)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in order")
    ap.add_argument("--phases", nargs="+", default=["6", "19"],
                    choices=sorted(PHASES))
    args = ap.parse_args()
    for tree in args.trees:
        run_tree(tree, args.phases)


if __name__ == "__main__":
    main()
