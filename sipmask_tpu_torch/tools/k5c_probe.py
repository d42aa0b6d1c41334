"""K5c, the row-sampling backward: the package's item kernel
(``csrc/deform_rows.cu``) against the tile design of ``k5c_tiles.cu`` beside
this file, and edited copies of it, on one CUDA card:

    python -m sipmask_tpu_torch.tools.k5c_probe [--variants [NAME ...]]
    PYTHONPATH=<tree> python sipmask_tpu_torch/tools/k5c_probe.py

The package is imported from ``PYTHONPATH`` (the second form: another
checkout, or an unpacked ``git archive`` of another commit), so one call
can time two trees' item kernels against the same tile kernel.

Inputs are ``tools/measure.py k5c``'s: one DCN conv of each R101 stage at
576x576, batch 8, offsets ~2 px with a third of the pixels +-300 px out,
from ``--seed``. Builds ``k5c_tiles.cu`` (and the edited copies: all, or
the named ones) into ``build/k5c_probe/``, then prints the card's name and
power limit, the memory and shuffle instructions of the tile kernel
(``cuobjdump -sass``: shared float atomics are ``ATOMS.CAST.SPIN`` loops on
sm_90), and the CUDA-event ms of the three-conv sweep (two turns) with its
error against the plain version: the item kernel (``deform_rows_backward``),
the tile kernel with tiles of at most 8x16 output pixels and a 4-pixel halo
(``tiles``), with other tiles and halos (``tile RxC halo H``), and each
edited copy. ``noatom`` and ``noshfl`` compute something else and are for
timing only:

- ``lb2``, ``lb3``: the tile kernel capped for 2 or 3 blocks an SM;
- ``unroll1``, ``unroll4``: 1 or 4 items a warp in flight (2 as built);
- ``noatom``: plain shared adds in place of shared atomics (racy);
- ``noshfl``: no warp sums of d position (lanes 0 and 16 keep theirs).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import threading
from pathlib import Path

import torch

from sipmask_tpu_torch.ops import deform_sample as ds
from sipmask_tpu_torch.ops import native

PP_DCN_TRAIN = [(128, 72, 72), (256, 36, 36), (512, 18, 18)]
PP_BATCH = 8
OUT = native.BUILD_DIR.parent / "k5c_probe"
SRC = Path(__file__).with_name("k5c_tiles.cu")
TILE_MAX, HALO = (8, 16), 4

EDITS = {
    "lb2": [("__launch_bounds__(kThreads) deform_rows_bwd_tiles_kernel",
             "__launch_bounds__(kThreads, 2) deform_rows_bwd_tiles_kernel")],
    "lb3": [("__launch_bounds__(kThreads) deform_rows_bwd_tiles_kernel",
             "__launch_bounds__(kThreads, 3) deform_rows_bwd_tiles_kernel")],
    "unroll1": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 1;")],
    "unroll4": [("constexpr int kUnroll = 2;", "constexpr int kUnroll = 4;")],
    "noatom": [("""          atomicAdd(win + ((int)cy * ww + (int)cx) * kChunkC + lane,
                    du * wgt);""",
                """          win[((int)cy * ww + (int)cx) * kChunkC + lane] +=
              du * wgt;""")],
    "noshfl": [("      const float sum = warp_sum_pair(gy, gx, lane);",
                "      const float sum = (lane & 16) ? gx : gy;")],
}


def log(*args):
    print(*args, flush=True)


def inputs(dev, seed):
    gen = torch.Generator().manual_seed(seed)
    args = []
    for c, h, w in PP_DCN_TRAIN:
        x = torch.randn((PP_BATCH, h * w, c), generator=gen).to(dev)
        off = torch.randn((PP_BATCH, 18, h, w), generator=gen) * 2.0
        off.view(PP_BATCH, 18, h * w)[:, :, : (h * w) // 3] *= 150.0
        pyx = ds.positions(off.to(dev), 3, 3, 1, 1, 1, 1).contiguous()
        g = torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
        args.append((x, pyx, g, h, w))
    return args


def cuda_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def tile_of(h, w, tmax):
    """Tiles of at most ``tmax`` that cut each side of an h x w map
    evenly (17 rows: 3 tiles of 6)."""
    return -(-h // -(-h // tmax[0])), -(-w // -(-w // tmax[1]))


def tiles_call(lib, a, tmax, halo):
    """One tile-route backward through ``lib`` with the given tile and
    halo, as ``deform_rows_backward`` launches it."""
    x, pyx, g, h, w = a
    n, _, cg = x.shape
    k, p = pyx.shape[1:3]
    dx = torch.zeros_like(x)
    dpyx = torch.empty_like(pyx)
    part = torch.empty((cg // 32, n, k, p, 2), device=x.device)
    code = lib.deform_rows_bwd_tiles_f32(
        x.data_ptr(), pyx.data_ptr(), g.data_ptr(), dx.data_ptr(),
        dpyx.data_ptr(), part.data_ptr(), n, h, w, cg, k,
        *tile_of(h, w, tmax), halo,
        native.stream_ptr(x.device))
    native.check_launch(lib, "deform_rows", code)
    return dx, dpyx


def error(args, call):
    """Largest error of (dx, dpyx) against the plain version, relative to
    each output's max |value|."""
    err = 0.0
    for a in args:
        got = call(a)
        want = ds.deform_rows_backward_plain(*a)
        for t, e in zip(got, want):
            err = max(err, float((t - e).abs().max()) /
                      float(e.abs().max()))
    return err


def build(name, text, built):
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    built[name] = lib if res.returncode == 0 else res.stderr


def load(path):
    lib = ctypes.CDLL(str(path))
    lib.deform_rows_error_string.argtypes = [ctypes.c_int]
    lib.deform_rows_error_string.restype = ctypes.c_char_p
    fn = lib.deform_rows_bwd_tiles_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help="edited copies to build and time (all if none "
                         "named)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5c_probe: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    names = list(EDITS) if args.variants == [] else (args.variants or [])
    text = SRC.read_text()
    built, threads = {}, []
    for name in ["tiles"] + names:
        edited = text
        for old, new in EDITS.get(name, []):
            if old not in edited:
                raise ValueError(f"variant {name}: edit not found")
            edited = edited.replace(old, new)
        threads.append(threading.Thread(target=build,
                                        args=(name, edited, built)))
        threads[-1].start()
    for t in threads:
        t.join()
    for name, lib in built.items():
        if not isinstance(lib, Path):
            raise RuntimeError(f"nvcc failed on {name}:\n{lib}")
    sass = subprocess.run([str(Path(native.find_nvcc()).parent /
                               "cuobjdump"), "-sass", str(built["tiles"])],
                          capture_output=True, text=True).stdout
    body = sass.split("deform_rows_bwd_tiles_kernel", 1)[-1].split(
        "Function :", 1)[0]
    ops = {}
    for line in body.splitlines():
        for op in ("ATOMS", "ATOMG", "ATOM.", "RED.", "REDG", "LDS", "STS",
                   "SHFL"):
            if op in line:
                words = line.split("*/", 1)[-1].split()
                key = words[1] if words[0].startswith("@") else words[0]
                ops[key] = ops.get(key, 0) + 1
                break
    log(f"tile kernel SASS, memory and shuffle instructions: {ops}")

    data = inputs(dev, args.seed)
    base = load(built["tiles"])
    runs = {"items": lambda: [ds.deform_rows_backward(*a) for a in data],
            "tiles": lambda: [tiles_call(base, a, TILE_MAX, HALO)
                              for a in data]}
    for t, halo in (((8, 8), 4), ((8, 8), 2), ((4, 16), 4), ((8, 16), 2),
                    ((16, 16), 2)):
        runs[f"tile {t[0]}x{t[1]} halo {halo}"] = (
            lambda t=t, halo=halo: [tiles_call(base, a, t, halo)
                                    for a in data])
    for name in names:
        lib = load(built[name])
        runs[name] = lambda lib=lib: [tiles_call(lib, a, TILE_MAX, HALO)
                                      for a in data]
    for name, run in runs.items():
        t1, t2 = cuda_ms(run), cuda_ms(run)
        results = iter(run())
        err = error(data, lambda a: next(results))
        log(f"K5c sweep {name}: {t1:.4f} / {t2:.4f} ms, error {err:.2e}")

if __name__ == "__main__":
    main()
