"""K5c, the row-sampling backward: the package's item kernel
(``csrc/deform_rows.cu``) against the tile design of ``k5c_tiles.cu`` beside
this file, and edited copies of it, on one CUDA card; and, with ``--bf16``,
the bf16 K5 and K5c against edited copies of ``csrc/deform_rows.cu``:

    python -m sipmask_tpu_torch.tools.k5c_probe [--variants [NAME ...]]
    python -m sipmask_tpu_torch.tools.k5c_probe --bf16 [NAME ...]
    PYTHONPATH=<tree> python sipmask_tpu_torch/tools/k5c_probe.py

The package is imported from ``PYTHONPATH`` (the third form: another
checkout, or an unpacked ``git archive`` of another commit), so one call
can time two trees' item kernels against the same tile kernel, or two
trees' bf16 wrappers (``--bf16 package``).

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

``--bf16`` (all variants without names): ``chip_smoke.py`` phase 23's
unit, one DCN conv of each R101 stage at 544x544, batch 8, bf16 rows and
cotangents; each variant is built from ``csrc/deform_rows.cu`` (and the
shared ``csrc/deform_corners.cuh``, where it edits that) into
``build/k5c_probe/bf16_<name>/`` and called through its C entries: the
CUDA-event ms of the three-conv sweep (two turns), the device ms of each
stage's call by kernel (``torch.profiler``, mean of 10), at random and, for
K5c, at zero offsets (integer positions: 3 of 4 corners skipped), with
each output's error against the plain version relative to its max and
whether two calls give the same d position bits. ``noatom`` and
``storeonly`` compute something else and are for timing only:

- ``base``: the source as it is; ``package``: the package's own wrappers
  (with their host work; the only one another tree can run);
- K5c (``base``: a half-warp an item, on a grid the card holds at once,
  looping): ``nopersist``, a block for every 16 items, one round each;
  ``lanes8``, the map of the first bf16 port (a warp an item, lanes of 8
  channels, two float4 reductions 16 bytes apart); ``warp``, a warp an
  item; ``noatom``, plain float4 stores in place of the reductions (what
  the atomics cost);
- K5 (``base``: blocks of at most 16 output pixels, halved down to 16
  blocks an SM; 8, 16 or 32 lanes an item at Cg 128, 256, 512; one round
  of items in flight): ``items1``, ``items2``, ``items4``, rounds of
  items a lane group keeps in flight; ``pixels8``, ``pixels32``, output
  pixels a block at most; ``blocks4``, halved down to 4 blocks an SM;
  ``fwdlanes8``, ``fwdlanes16``, ``fwdlanes32``, lanes an item at every
  Cg; ``storeonly``, no reads of x, only the writes of sampled (its write
  floor).

``a+b`` names a variant with a's edits and b's.
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
PP_DCN = [(128, 68, 68), (256, 34, 34), (512, 17, 17)]   # serving (544)
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


# ------------------------------------------------------------ --bf16

def bf16_edits():
    """name -> (kernel: "k5c", "k5" or "both", [(file, old, new)]): the
    edits of each variant of ``csrc/deform_rows.cu`` (file "cu") and the
    shared ``csrc/deform_corners.cuh`` ("cuh")."""
    fwd_lanes = "return Cg >= 512 ? 32 : Cg >= 256 ? 16 : 8;"
    red = "if (a{0}) atomicAdd(dxn + c.q{0} * cv + v, scaled(d, c.w{0}));"
    grid = "(n_items * LANES + kThreads - 1) / kThreads"
    return {
        "base": ("both", []),
        "nopersist": ("k5c", [("cu", f"std::min(cap, {grid})", grid)]),
        "lanes8": ("k5c", [("cu", "if (!vec)\n      err = bwd<bf16, 1>(",
                            "if (vec)\n      err = bwd<bf16, 8>(")]),
        "warp": ("k5c", [("cu", "constexpr int kBwdLanes = 16;",
                          "constexpr int kBwdLanes = 32;")]),
        "noatom": ("k5c", [("cuh", red.format(c),
                            f"if (a{c}) dxn[c.q{c} * cv + v] = "
                            f"scaled(d, c.w{c});")
                           for c in ("00", "01", "10", "11")]),
        **{f"items{i}": ("k5", [("cu", "constexpr int kFwdItems = 1;",
                                 f"constexpr int kFwdItems = {i};")])
           for i in (1, 2, 4)},
        **{f"pixels{i}": ("k5", [("cu", "constexpr int kFwdPixels = 16;",
                                  f"constexpr int kFwdPixels = {i};")])
           for i in (8, 32)},
        "blocks4": ("k5", [("cu", "kFwdBlocks = 16 * 132;",
                            "kFwdBlocks = 4 * 132;")]),
        **{f"fwdlanes{i}": ("k5", [("cu", fwd_lanes, f"return {i};")])
           for i in (8, 16, 32)},
        "storeonly": ("k5", [(
            "cu", "uint2 corner_load(const uint2* p) { return *p; }",
            "uint2 corner_load(const uint2* p) {\n  (void)p;\n"
            "  return make_uint2(0x3F803F80u, 0x3F803F80u);\n}")]),
    }


def bf16_variant(name, texts):
    """(kernel, {file: edited text}) of ``name``, or of ``a+b``: a's
    edits, then b's."""
    edits = bf16_edits()
    kinds, texts = set(), dict(texts)
    for part in name.split("+"):
        kind, pairs = edits[part]
        kinds.add(kind)
        for f, old, new in pairs:
            if texts[f].count(old) != 1:
                raise ValueError(f"variant {part}: {old!r} is not in the "
                                 f"source once")
            texts[f] = texts[f].replace(old, new)
    kinds.discard("both")
    return (kinds.pop() if len(kinds) == 1 else "both"), texts


def build_rows(name, texts, built):
    out = OUT / f"bf16_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "deform_corners.cuh").write_text(texts["cuh"])   # shadows csrc's
    src, so = out / "deform_rows.cu", out / "deform_rows.so"
    src.write_text(texts["cu"])
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(src)],
                         capture_output=True, text=True)
    built[name] = (so, res.stderr) if res.returncode == 0 else res.stderr


def load_rows(path):
    lib = ctypes.CDLL(str(path))
    for fn, n_ptr in ((lib.deform_rows_fwd_bf16, 3),
                      (lib.deform_rows_bwd_bf16, 6)):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
    lib.deform_rows_error_string.argtypes = [ctypes.c_int]
    lib.deform_rows_error_string.restype = ctypes.c_char_p
    return lib


def bf16_inputs(dev, seed, zero):
    gen = torch.Generator().manual_seed(seed)
    args = []
    for c, h, w in PP_DCN:
        x = torch.randn((PP_BATCH, h * w, c), generator=gen).to(dev)
        off = torch.randn((PP_BATCH, 18, h, w), generator=gen) * 2.0
        off.view(PP_BATCH, 18, h * w)[:, :, : (h * w) // 3] *= 150.0
        if zero:
            off.zero_()
        pyx = ds.positions(off.to(dev), 3, 3, 1, 1, 1, 1).contiguous()
        g = torch.randn((PP_BATCH, h * w, 9, c), generator=gen).to(dev)
        args.append((x.to(torch.bfloat16), pyx, g.to(torch.bfloat16), h, w))
    return args


def bf16_calls(lib, data):
    """(K5 call, K5c call) per input of ``data``, through ``lib``'s C
    entries on preallocated outputs, or the package's wrappers (``lib``
    None); each returns its outputs."""
    calls = []
    for x, pyx, g, h, w in data:
        if lib is None:
            calls.append((lambda x=x, pyx=pyx, h=h, w=w:
                          (ds.deform_rows(x, pyx, h, w),),
                          lambda x=x, pyx=pyx, g=g, h=h, w=w:
                          ds.deform_rows_backward(x, pyx, g, h, w)))
            continue
        n, _, cg = x.shape
        k, p = pyx.shape[1:3]
        out = torch.empty((n, p, k, cg), device=x.device, dtype=x.dtype)
        dx32 = torch.empty(x.shape, device=x.device)
        dx, dpyx = torch.empty_like(x), torch.empty_like(pyx)
        stream = native.stream_ptr(x.device)

        def fwd(x=x, pyx=pyx, out=out, h=h, w=w, n=n, cg=cg, k=k, p=p):
            native.check_launch(lib, "deform_rows", lib.deform_rows_fwd_bf16(
                x.data_ptr(), pyx.data_ptr(), out.data_ptr(), n, h, w, cg,
                k, p, 1, stream))
            return (out,)

        def bwd(x=x, pyx=pyx, g=g, dx32=dx32, dx=dx, dpyx=dpyx, h=h, w=w,
                n=n, cg=cg, k=k, p=p):
            native.check_launch(lib, "deform_rows", lib.deform_rows_bwd_bf16(
                x.data_ptr(), pyx.data_ptr(), g.data_ptr(), dx32.data_ptr(),
                dx.data_ptr(), dpyx.data_ptr(), n, h, w, cg, k, p, 1,
                stream))
            return dx.clone(), dpyx.clone()
        calls.append((fwd, bwd))
    return calls


def rel_error(got, want):
    return max(float((a.float() - b.float()).abs().max())
               / float(b.float().abs().max()) for a, b in zip(got, want))


def bf16_probe(label, which, lib, data, check):
    """Log one variant's sweep (events, two turns) and each stage's call
    by device kernel, with its error against the plain versions."""
    from sipmask_tpu_torch.tools.measure import kernel_name, profile_kernels
    calls = bf16_calls(lib, data)
    for i, kern in ((0, "K5"), (1, "K5c")):
        if which not in ("both", kern.lower()):
            continue
        sweep = [c[i] for c in calls]
        t1 = cuda_ms(lambda: [f() for f in sweep], iters=10)
        t2 = cuda_ms(lambda: [f() for f in sweep], iters=10)
        parts = []
        for (c, h, w), f in zip(PP_DCN, sweep):
            by = {}
            for e in profile_kernels(f, 10):
                by[kernel_name(e.name)] = by.get(kernel_name(e.name), 0.0) \
                    + e.device_time / 1e4
            parts.append(f"Cg {c}: {sum(by.values()):.4f} (" + ", ".join(
                f"{k} {v:.4f}" for k, v in by.items()) + ")")
        err = ""
        if check:
            errs = []
            for (x, pyx, g, h, w), f in zip(data, sweep):
                got = f()
                want = ((ds.deform_rows_plain(x, pyx, h, w),) if i == 0
                        else ds.deform_rows_backward_plain(x, pyx, g, h, w))
                errs.append(rel_error(got, want))
                if i == 1 and not torch.equal(got[1], f()[1]):
                    raise AssertionError(f"{label}: two calls gave other d "
                                         f"position bits")
            err = f", error {max(errs):.2e}" + (
                ", d positions the same bits twice" if i == 1 else "")
        log(f"{kern} bf16 {label}: sweep {t1:.4f} / {t2:.4f} ms (events)"
            f"{err}; device ms a call: " + "; ".join(parts))


def bf16_main(names, seed):
    dev = torch.device("cuda", 0)
    names = names or ["package"] + list(bf16_edits())
    sources = {"cu": (native.CSRC_DIR / "deform_rows.cu").read_text(),
               "cuh": (native.CSRC_DIR / "deform_corners.cuh").read_text()}
    variants = {name: bf16_variant(name, sources) for name in names
                if name != "package"}
    built, threads = {}, []
    for name, (_, texts) in variants.items():
        threads.append(threading.Thread(target=build_rows,
                                        args=(name, texts, built)))
        threads[-1].start()
    for th in threads:
        th.join()
    for name, res in built.items():
        if not isinstance(res, tuple):
            raise RuntimeError(f"nvcc failed on {name}:\n{res}")
    if "base" in built:   # registers of the bf16 kernels
        lines = built["base"][1].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "bf16x4" in line:
                log(line.split("'")[1][:60] + ": " + " ".join(
                    s.strip() for s in lines[i + 2:i + 4]))
    for zero in (False, True):
        data = bf16_inputs(dev, seed, zero)
        for name in names:
            which = "both" if name == "package" else variants[name][0]
            if zero and which == "k5":
                continue
            lib = None if name == "package" else load_rows(built[name][0])
            bf16_probe(f"{name} {'zero' if zero else 'random'} offsets",
                       "k5c" if zero else which, lib, data,
                       not {"noatom", "storeonly"} & set(name.split("+")))
        del data
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help="edited copies to build and time (all if none "
                         "named)")
    ap.add_argument("--bf16", nargs="*", default=None, metavar="NAME",
                    help="the bf16 K5 and K5c variants to time (all if "
                         "none named)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k5c_probe: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    if args.bf16 is not None:
        bf16_main(args.bf16, args.seed)
        return
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
