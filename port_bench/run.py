"""Run one cell of the benchmark once.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the chips the cell asks
for. The last line of standard output is the result (JSON); the last
lines of standard error give each number that decided ``correct`` beside
its limit. ``--trace 0`` measures the cell's end-to-end metrics, ``--trace
1`` its per-layer ones.

``--control tf32`` puts the reference, computed in TF32, in the program's
place (the check's control, which has to come out not correct);
``--fault`` plants a fault in the timed path. Neither is part of a
measured run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sipmask_tpu")


def _caches():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: ``sipmask_tpu_torch`` is not
    ``sipmask_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    ap.add_argument("--fault")
    args = ap.parse_args(argv)
    _caches()

    import torch

    from . import harness, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{count}", file=sys.stderr)
        return 3
    from . import program
    program.no_tf32()
    torch.backends.cudnn.benchmark = False
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T0, control=args.control,
                      fault=args.fault)
    result, notes = spec.kind(cell.traffic).run(run)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 4
    harness.emit(result, notes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
