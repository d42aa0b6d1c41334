"""K1 (deformable im2col, ``csrc/deform_im2col.cu``) and K6 (SP mask
assembly, ``csrc/mask_assembly.cu``) at their smoke units on one CUDA card,
and edited copies of both, to see what bounds them:

    PYTHONPATH=<tree> python <this file> [--bf16] [--save out.pt]
        [--against ref.pt] [--variants [NAME ...]]

The package is imported from ``<tree>`` (a checkout, or an unpacked ``git
archive`` of another commit), and its kernels build there, so one command
can time two trees on one card. Inputs are ``chip_smoke.py``'s, from
``--seed``: K1 over the flagship's five FeatureAlign levels at batch 4
(800x1344, 256 channels, 4 deformable groups; offsets ~2 px, a third of the
pixels +-300 px out); K6 at the decode's unit (272x272 grid, 100
detections, batch 8) and the SipMask++ rescoring loss's (288x288, K = 256,
batch 8), boxes covering 5-60% of the grid, a fifth of zero width. Prints
the card's name and power limit, then for each unit: the CUDA-event ms of a
call or sweep (two turns), the device kernels of one call with their ms
(``torch.profiler``), and the error against the plain version (K6: and
whether its zeros are the plain version's), and as a yardstick of K1's
write stream a ``fill_`` of its five cols tensors. ``--save`` writes the
outputs;
``--against`` compares them bit for bit with a saved run's.

``--bf16`` takes the bf16 K1 alone (x and cols bf16, offsets f32), at two
units: the flagship's five levels at batch 4 and the 544x544 levels at
batch 8 (SipMask++ and real-time serving), each at random (~2 px), far (a
third +-300 px out: the timed inputs) and zero offsets: the error against
the plain version and whether two calls give the same bits, then at far
the sweep's CUDA-event ms, its device ms by kernel and level (transposes
and gathers; averaged over the whole sweeps of a profiled session) and a
``fill_`` of its bf16 cols. ``--save`` / ``--against`` then hold the SHA-256
of each level's cols in each regime (a strided sample beside it says how
far a differing one is). ``--variants`` builds edited copies of the bf16
design into ``build/k1k6_probe/`` and times each through its C entry in
the same way (names below; ``a+b`` applies both; another tree's older
source takes the names that have an edit for it): ``storeonly`` (no
transpose, no corners, no gather: the stores of unfilled tiles, the write
ceiling), ``nogather`` (the transpose and corners kept, no corner reads),
``tile32`` (32-pixel tiles, the f32 design's: one item a thread on half
the threads), ``notma`` (register stores everywhere: 16 bytes where P %
8 == 0), ``nopdl`` (the gather launched without programmatic dependent
launch), ``taps9`` (every block all K taps: no tap groups at the small
levels), ``fill4``, ``fill8`` (tap groups up to 4 or 8 blocks an SM, not
16), ``lb3`` (registers capped for 3 blocks an SM, 4 as built).

``--variants`` without ``--bf16`` builds edited copies of this tree's two
sources into
``build/k1k6_probe/`` (all, or the named ones; ``a+b`` applies both) and
times each through its C entry at the same units, with its error against
the plain version. ``base`` is the source as it is; ``storeonly``,
``nobasis``, ``nogather``, ``nostore``, ``notranspose`` and
``transposeonly`` compute something else, for timing only:

- K6 (``k6:`` names): ``storeonly`` (every segment stores zeros with no
  dot: the write ceiling), ``lanetest`` (no segment cull: every segment
  takes the per-lane test, which skips the dot where no lane is in the
  box), ``nobasis`` (no basis reads), ``segs2`` (two 32-pixel segments a
  warp), ``warps4`` (4 warps a block, 8 as built), ``lb3`` (registers
  uncapped, 3 blocks an SM; capped for 4 as built), ``stwb`` (write-back
  stores, not streaming), ``libmsig`` (the sigmoid as
  ``1 / (1 + expf(-s))``), ``fdiv`` (as ``__fdividef(1, 1 + __expf(-s))``);
- K1 (``k1:`` names): ``nogather`` (no corner reads: cols written from an
  unfilled tile, the write ceiling with the transpose), ``nostore`` (no cols
  stores), ``nocorner`` (neither the corner phase nor the gather: the
  write-out of unfilled tiles with no offsets read), ``notranspose`` (the
  gather alone, on an unfilled x_rows), ``transposeonly``, ``cgrt`` (Cg = 64
  as a runtime value, not a compile-time one), ``rev`` (the transpose walks
  the images in reverse, so that the first the gather reads are the last
  written, still in the L2), ``noprefetch`` (each round's corner loads
  issued where they are used), ``it1``, ``it4`` (1 or 4 items a thread in
  flight, 2 as built), ``nolb`` (registers uncapped; capped for 4 blocks an
  SM as built), ``ldcg`` (corner loads cached in the L2 only), ``tile16``,
  ``tile64`` (16- or 64-pixel tiles, 32 as built), ``t64`` (64x64 transpose
  tiles, 32x32 as built), ``defer`` (the corners past the first 256 worked
  out after tap 0's loads are issued), ``carve50`` (a shared-memory carveout
  of 50%, the rest L1), ``out1`` (scalar cols stores where float4 would do),
  ``vec1`` (scalar gathers where 16-byte vectors would do); and the second
  design, one tap and 32 channels a block of 128 pixels (``k1_tiles.cu``
  beside this file): ``tiles`` (as kept), ``tiles_noswz`` (odd-stride scalar
  shared stores, not the swizzled 16-byte ones), ``tiles_pix256`` (256-pixel
  tiles), ``tiles_unroll2`` (the corner loads of two items a thread in
  flight).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import subprocess
import threading
from pathlib import Path

import torch

from sipmask_tpu_torch.ops import deform_sample, mask_assembly, native
from sipmask_tpu_torch.tools.measure import kernel_name

LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # 800x1344
BATCH, CHANNELS, GROUPS = 4, 256, 4
PP_BATCH = 8
K6_UNITS = {"decode 272x272 N=100": (272, 272, 100),
            "rescoring 288x288 K=256": (288, 288, 256)}

EDITS = {
    "k6:storeonly": [("if ((hits >> j) & 1)", "if (false)")],
    "k6:lanetest": [("if ((hits >> j) & 1)", "if (true)")],
    "k6:nobasis": [("v[s][k] = p[s] < HW ? __ldg(bb + (int64_t)k * HW + p[s])"
                    " : 0.f;", "v[s][k] = (float)k;")],
    "k6:segs2": [("constexpr int kSegs = 1;", "constexpr int kSegs = 2;")],
    "k6:warps4": [("constexpr int kWarps = 8;", "constexpr int kWarps = 4;")],
    "k6:lb3": [("__launch_bounds__(kThreads, 4) assemble_masks_kernel",
                "__launch_bounds__(kThreads) assemble_masks_kernel")],
    "k6:stwb": [("if (live) __stcs(o, val);", "if (live) *o = val;")],
    "k6:libmsig": [("val = __frcp_rn(1.f + __expf(-acc));",
                    "val = 1.f / (1.f + expf(-acc));")],
    "k6:fdiv": [("val = __frcp_rn(1.f + __expf(-acc));",
                 "val = __fdividef(1.f, 1.f + __expf(-acc));")],
    "k1:nogather": [("const int items = kTile * cv;",
                     "const int items = 0;")],
    "k1:nostore": [("for (int i = threadIdx.x; i < Cg * kLanes; "
                    "i += kThreads) {",
                    "for (int i = threadIdx.x; i < 0; i += kThreads) {")],
    "k1:notranspose": [("  deform_im2col_rows_kernel<E><<<tgrid, kThreads, 0, "
                        "s>>>(x, x_rows, Cg, HW);\n", "")],
    "k1:transposeonly": [("  const bool out4 = (Ho * Wo) % 4 == 0;",
                          "  if (BG > 0) return 0;\n"
                          "  const bool out4 = (Ho * Wo) % 4 == 0;")],
    "k1:cgrt": [("    if (vec && Cg == 64)", "    if (false)")],
    "k1:rev": [("  const int64_t bg = blockIdx.z;\n"
                "  const int p0 = blockIdx.x * kT, c0 = blockIdx.y * kT;",
                "  const int64_t bg = gridDim.z - 1 - blockIdx.z;\n"
                "  const int p0 = blockIdx.x * kT, c0 = blockIdx.y * kT;")],
    "k1:tile16": [("constexpr int kTile = 32;", "constexpr int kTile = 16;")],
    "k1:t64": [("constexpr int kT = 32;", "constexpr int kT = 64;")],
    # corners past the first kThreads items (tap 8's) worked out after tap
    # 0's loads are issued, before tap 0's barrier
    "k1:defer": [("  for (int i = threadIdx.x; i < K * kTile; "
                  "i += kThreads) {\n"
                  "    const int t = i / kTile, j = i - t * kTile;",
                  "  auto corner = [&](int i) {\n"
                  "    const int t = i / kTile, j = i - t * kTile;"),
                 ("    cw[i] = w;\n    cq[i] = q;\n  }\n  __syncthreads();\n",
                  "    cw[i] = w;\n    cq[i] = q;\n  };\n"
                  "  if (threadIdx.x < K * kTile) corner(threadIdx.x);\n"
                  "  __syncthreads();\n"),
                 ("  issue(0, 0);\n",
                  "  issue(0, 0);\n"
                  "  for (int i = kThreads + threadIdx.x; i < K * kTile; "
                  "i += kThreads)\n    corner(i);\n")],
    # corner loads cached in the L2 only
    "k1:ldcg": [(f"? {ld} :", f"? __ldcg(&{ld}) :") for ld in (
        f"xb[(int64_t)q.{c} * cv + v]" for c in "xyzw")],
    # neither corner phase nor gather: the write-out of unfilled tiles
    "k1:nocorner": [("  for (int i = threadIdx.x; i < K * kTile; "
                     "i += kThreads) {\n    const int t = i / kTile",
                     "  for (int i = threadIdx.x; i < 0; "
                     "i += kThreads) {\n    const int t = i / kTile"),
                    ("const int items = kTile * cv;",
                     "const int items = 0;")],
    "k1:tile64": [("constexpr int kTile = 32;", "constexpr int kTile = 64;")],
    "k1:nolb": [("__launch_bounds__(kThreads, 4) deform_im2col_kernel(",
                 "__launch_bounds__(kThreads) deform_im2col_kernel(")],
    "k1:it1": [("constexpr int kIt = 2;", "constexpr int kIt = 1;")],
    "k1:it4": [("constexpr int kIt = 2;", "constexpr int kIt = 4;")],
    "k1:noprefetch": [("      if (r + 1 < rounds)\n        issue(t, r + 1);\n"
                       "      else if (t + 1 < K)\n        issue(t + 1, 0);\n",
                       ""),
                      ("    for (int r = 0; r < rounds; ++r) {\n"
                       "#pragma unroll",
                       "    for (int r = 0; r < rounds; ++r) {\n"
                       "      issue(t, r);\n#pragma unroll"),
                      ("  issue(0, 0);\n", "")],
    "k1:carve50": [("  if (smem > 48 * 1024) {",
                    "  cudaFuncSetAttribute(kernel, "
                    "cudaFuncAttributePreferredSharedMemoryCarveout, 50);\n"
                    "  if (smem > 48 * 1024) {")],
    "k1:out1": [("  const bool out4 = (Ho * Wo) % 4 == 0;",
                 "  const bool out4 = false;")],
    "k1:vec1": [("    if (vec && Cg == 64)", "    if (false)"),
                ("    if (vec && Cg % kVec == 0)", "    if (false)")],
    # the one-tap design, tools/k1_tiles.cu: as kept, and edited
    "k1:tiles": [],
    "k1:tiles_noswz": [("  if (vec && Cg % kCh == 0)", "  if (false)")],
    "k1:tiles_pix256": [("constexpr int kPix = 128;",
                         "constexpr int kPix = 256;")],
    "k1:tiles_unroll2": [("constexpr int kUnroll = 1;",
                          "constexpr int kUnroll = 2;")],
}
TILES = Path(__file__).with_name("k1_tiles.cu")
SOURCES = {"k6": "mask_assembly", "k1": "deform_im2col"}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters, warmup=3):
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


def split(fn, attempts=3):
    """The device kernels of one fn() as [(name, ms)], from the fullest of
    ``attempts`` profiler sessions, each behind a marker kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        seen.append([(e.name, e.device_time / 1e3) for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "spin_kernel" not in e.name])
    return max(seen, key=len)


def k1_inputs(gen, dev):
    """As ``chip_smoke.k1_inputs`` at every level, batch 4."""
    out = []
    for h, w in LEVELS:
        x = torch.randn((BATCH, CHANNELS, h, w), generator=gen).to(dev)
        off = torch.randn((BATCH, GROUPS * 18, h, w), generator=gen) * 2.0
        off.view(BATCH, GROUPS * 18, h * w)[:, :, : (h * w) // 3] *= 150.0
        out.append((x, off.to(dev)))
    return out


def k6_inputs(h, w, n, gen, dev):
    """As ``chip_smoke.k6_inputs``, batch 8."""
    b = PP_BATCH
    basis = torch.randn((b, 32, h, w), generator=gen).to(dev)
    cofs = (torch.randn((b, n, 128), generator=gen) * 0.3).to(dev)
    frac = torch.sqrt(torch.rand((b, n, 1), generator=gen) * 0.55 + 0.05)
    wh = frac * torch.tensor([w, h], dtype=torch.float32)
    ctr = torch.rand((b, n, 2), generator=gen) * torch.tensor(
        [w, h], dtype=torch.float32)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    boxes[:, ::5, 2] = boxes[:, ::5, 0]
    return basis.permute(0, 2, 3, 1), cofs, boxes.to(dev)


def max_abs(got, want):
    return float((got - want).abs().max())


def ptxas_summary(report):
    """Each kernel's registers and spills from an ``nvcc -Xptxas -v``
    report."""
    items, kernel, spilled = [], "?", "?"
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:   # the mangled name's identifier and template arguments
            k = re.search(r"(?:deform|assemble)\w*?_kernel(?:I\w*?EE)?",
                          m.group(1))
            kernel = k.group(0) if k else m.group(1)[-40:]
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spilled = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            items.append(f"{kernel} {m.group(1)} regs, {spilled} B spilled")
    return "; ".join(items)


def variants(names):
    """{name: (source stem, edited text)}: ``k1:base``, ``k6:base`` and the
    named variants ('a+b' applies both; all when ``names`` is empty). The
    ``k1:tiles`` variants edit ``k1_tiles.cu``."""
    names = names or list(EDITS)
    out = {f"{k}:base": (stem, (native.CSRC_DIR / f"{stem}.cu").read_text())
           for k, stem in SOURCES.items()}
    for name in names:
        kern = name.split(":")[0]
        stem = SOURCES[kern]
        text = (TILES if name.startswith("k1:tiles") else
                native.CSRC_DIR / f"{stem}.cu").read_text()
        for part in name.split("+"):
            part = part if ":" in part else f"{kern}:{part}"
            for old, new in EDITS[part]:
                if old not in text:
                    raise RuntimeError(f"{part}: {stem}.cu no longer has "
                                       f"{old!r}")
                # the first: K1's f32 kernels precede its bf16 design
                text = text.replace(old, new, 1)
        out[name] = (stem, text)
    return out


def build(name, stem, text, out_dir, built):
    tag = re.sub(r"\W", "_", name)
    cu, so = out_dir / f"{tag}.cu", out_dir / f"{tag}.so"
    cu.write_text(text)
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    built[name] = (so, ptxas_summary(res.stderr)) if res.returncode == 0 \
        else res.stderr


def time_variants(names, k1_in, k6_in, want, iters):
    out_dir = native.BUILD_DIR.parent / "k1k6_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = variants(names)
    built = {}
    threads = [threading.Thread(target=build, args=(n, s, t, out_dir, built))
               for n, (s, t) in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dev = k1_in[0][0].device
    stream = native.stream_ptr(dev)
    for name, (stem, _) in texts.items():
        if not isinstance(built[name], tuple):
            raise RuntimeError(f"nvcc failed on {name}:\n{built[name]}")
        lib = ctypes.CDLL(str(built[name][0].resolve()))
        if stem == "mask_assembly":
            fn = lib.assemble_masks_f32
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            res = []
            for label, (basis, cofs, boxes) in k6_in.items():
                b, h, w, _ = basis.shape
                n = cofs.shape[1]
                bc = basis.permute(0, 3, 1, 2)
                o = torch.empty((b, n, h, w), device=dev)

                def call(bc=bc, cofs=cofs, boxes=boxes, o=o, b=b, h=h, w=w,
                         n=n):
                    code = fn(bc.data_ptr(), cofs.data_ptr(),
                              boxes.data_ptr(), o.data_ptr(), b, h, w, n,
                              stream)
                    if code:
                        raise RuntimeError(f"{name}: CUDA error {code}")
                t1, t2 = cuda_ms(call, iters), cuda_ms(call, iters)
                err = max_abs(o.permute(0, 2, 3, 1), want[label])
                res.append(f"{label} {t1:.4f} / {t2:.4f} ms (err "
                           f"{err:.2e})")
        else:
            fn = lib.deform_im2col_f32
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [
                ctypes.c_void_p]
            bufs = []
            for x, off in k1_in:
                b, c, h, w = x.shape
                bufs.append((torch.empty((b * GROUPS, h * w, c // GROUPS),
                                         device=dev),
                             torch.empty((b, 9 * c, h * w), device=dev)))

            def sweep():
                for (x, off), (xr, cols) in zip(k1_in, bufs):
                    b, c, h, w = x.shape
                    code = fn(x.data_ptr(), off.data_ptr(), xr.data_ptr(),
                              cols.data_ptr(), b, c, h, w, GROUPS, h, w, 3,
                              3, 1, 1, 1, int((c // GROUPS) % 4 == 0),
                              stream)
                    if code:
                        raise RuntimeError(f"{name}: CUDA error {code}")
            t1, t2 = cuda_ms(sweep, iters), cuda_ms(sweep, iters)
            sweep()
            err = max(max_abs(cols, wc) for (_, cols), wc
                      in zip(bufs, want["k1"]))
            res = [f"5-level sweep {t1:.4f} / {t2:.4f} ms (err {err:.2e})"]
        log(f"variant {name}: " + "; ".join(res) + f"; {built[name][1]}")


# --bf16: the bf16 K1 (deform_im2col_bf16) at two units, in three offset
# regimes
PP_LEVELS = [(68, 68), (34, 34), (17, 17), (9, 9), (5, 5)]   # 544x544
BF16_UNITS = {"800x1344 bs4": (LEVELS, BATCH),
              "544x544 bs8": (PP_LEVELS, PP_BATCH)}
REGIMES = ("random", "far", "zero")
# Edited copies of the bf16 K1. Each is a list of alternative edit sets:
# the first whose texts all occur in the source applies, so that another
# tree's source (the f32 design templated for bf16) takes the same names
# where it can.
_NO_TRANSPOSE = [
    ("  if (HW % 8 == 0)\n    deform_im2col_rows_bf16_kernel<8>",
     "  if (HW < 0)\n    deform_im2col_rows_bf16_kernel<8>"),
    ("  else\n    deform_im2col_rows_bf16_kernel<1>",
     "  else if (HW < 0)\n    deform_im2col_rows_bf16_kernel<1>")]
BF16_EDITS = {
    # the write ceiling: no transpose, no corners, no gather; the stores of
    # unfilled tiles
    "storeonly": [
        _NO_TRANSPOSE + [
            ("for (int i = threadIdx.x; i < nt * kPix; i += kThreads) {",
             "for (int i = threadIdx.x; i < 0; i += kThreads) {"),
            ("const int items = (kPix / 2) * cv;", "const int items = 0;")],
        [("  deform_im2col_rows_kernel<E><<<tgrid, kThreads, 0, s>>>(x, "
          "x_rows, Cg, HW);\n", ""),
         ("  for (int i = threadIdx.x; i < K * kTile; i += kThreads) {\n"
          "    const int t = i / kTile",
          "  for (int i = threadIdx.x; i < 0; i += kThreads) {\n"
          "    const int t = i / kTile"),
         ("const int items = kTile * cv;", "const int items = 0;")]],
    # the transpose and the corners kept, no corner reads
    "nogather": [
        [("const int items = (kPix / 2) * cv;", "const int items = 0;")],
        [("const int items = kTile * cv;", "const int items = 0;")]],
    # 32-pixel tiles (the f32 design's), one item a thread on half the
    # threads
    "tile32": [[("constexpr int kPix = 64;", "constexpr int kPix = 32;")]],
    # register stores everywhere (16 bytes where P % 8 == 0)
    "notma": [[("return P % 8 == 0 ? 0 : ", "return P % 8 == 0 ? 8 : ")]],
    # the gather launched without programmatic dependent launch
    "nopdl": [[("constexpr bool kPdl = true;", "constexpr bool kPdl = false;")]],
    # all K taps a block at every level (no tap groups at small levels)
    "taps9": [[("constexpr int kFillBlocks = 16 * 132;",
                "constexpr int kFillBlocks = 0;")]],
    # tap groups up to a quarter or half the blocks
    "fill4": [[("constexpr int kFillBlocks = 16 * 132;",
                "constexpr int kFillBlocks = 4 * 132;")]],
    "fill8": [[("constexpr int kFillBlocks = 16 * 132;",
                "constexpr int kFillBlocks = 8 * 132;")]],
    # registers capped for 3 blocks an SM (4 as built)
    "lb3": [[("__launch_bounds__(kThreads, 4) deform_im2col_bf16_kernel(",
              "__launch_bounds__(kThreads, 3) deform_im2col_bf16_kernel(")]],
}


def bf16_inputs(levels, b, regime, gen, dev):
    """``chip_smoke.py`` phase 19's K1 inputs at ``levels``, batch ``b``:
    x ~ N(0, 1) in bf16, f32 offsets ~2 px (``random``), with a third of
    the pixels +-300 px out (``far``, phase 19's), or 0 (``zero``)."""
    out = []
    for h, w in levels:
        x = torch.randn((b, CHANNELS, h, w), generator=gen)
        off = torch.randn((b, GROUPS * 18, h, w), generator=gen) * 2.0
        if regime == "far":
            off.view(b, GROUPS * 18, h * w)[:, :, : (h * w) // 3] *= 150.0
        elif regime == "zero":
            off.zero_()
        out.append((x.to(dev).to(torch.bfloat16), off.to(dev)))
    return out


def profiled(fn, reps):
    """Device-kernel events of ``reps`` fn() in one profiler session
    behind a marker kernel, in launch order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.name),
                  key=lambda e: e.time_range.start)


def by_level(sweep, n_calls, reps=6, attempts=3):
    """Device ms of each call of a sweep (``n_calls`` calls of the same
    number of kernels) by kernel, [{name: ms}], averaged over the whole
    sweeps of a profiled session of ``reps`` (the card's profiler may drop
    a session's first kernels: a partial first sweep is left out); the
    kernels a sweep from the fullest of ``attempts`` lone sweeps."""
    per_sweep = max(len(profiled(sweep, 1)) for _ in range(attempts))
    per_call = per_sweep // n_calls
    for _ in range(attempts):
        kern = profiled(sweep, reps)
        n = len(kern) // per_sweep
        kern = kern[len(kern) - n * per_sweep:]
        names = [e.name for e in kern]
        if n and names == names[:per_sweep] * n:
            break
    else:
        raise RuntimeError(f"no session held whole sweeps of {per_sweep} "
                           f"kernels")
    out = []
    for i in range(n_calls):
        parts = {}
        for s in range(n):
            for e in kern[s * per_sweep + i * per_call:][:per_call]:
                name = kernel_name(e.name)
                parts[name] = parts.get(name, 0.0) + e.device_time / 1e3 / n
        out.append(parts)
    return out


def log_split(label, levels, parts):
    """Log a sweep's device ms: the transposes' (kernels named ``rows``),
    the gathers' and each level's by kernel."""
    rows = sum(ms for p in parts for n, ms in p.items() if "rows" in n)
    total = sum(ms for p in parts for ms in p.values())
    log(f"  {label}: device {total:.4f} ms (transposes {rows:.4f}, gathers "
        f"{total - rows:.4f}); by level: " + "; ".join(
            f"{h}x{w} " + " + ".join(f"{n} {ms:.4f}" for n, ms in p.items())
            for (h, w), p in zip(levels, parts)))
    return total


def digest(t):
    """SHA-256 of a tensor's bytes and a strided sample of its values."""
    t = t.contiguous()
    return (hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                           ).hexdigest(), t.flatten()[::9973].float().cpu())


def rel_err(got, want):
    return max(float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got, want))


def bf16_base(dev, gen, iters):
    """The package's bf16 K1 at each unit: in each regime the error against
    the plain version (relative to each level's max) and whether two calls
    give the same bits; at ``far`` the sweep's CUDA-event ms, its device
    ms by kernel and level, and a ``fill_`` of its cols. Returns (inputs,
    plain outputs, saved digests) by unit."""
    ins, wants, saved = {}, {}, {}
    for unit, (levels, b) in BF16_UNITS.items():
        saved[unit] = {}
        for regime in REGIMES:
            xs = bf16_inputs(levels, b, regime, gen, dev)

            def sweep(xs=xs):
                return [deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1,
                                                    GROUPS) for x, o in xs]
            with torch.no_grad():
                got, again = sweep(), sweep()
                want = [deform_sample.deform_im2col_plain(
                    x, o, (3, 3), 1, 1, 1, GROUPS) for x, o in xs]
            same = all(torch.equal(a, g) for a, g in zip(again, got))
            log(f"K1 bf16 {unit} {regime}: err vs plain {rel_err(got, want):.3e}"
                f" of each level's max; two calls "
                f"{'the same bits' if same else 'DIFFER'}")
            saved[unit][regime] = [digest(g) for g in got]
            del again
            if regime != "far":
                continue
            ins[unit], wants[unit] = xs, want
            t1, t2 = cuda_ms(sweep, iters), cuda_ms(sweep, iters)
            log(f"K1 bf16 {unit} {regime}: CUDA events {t1:.4f} / {t2:.4f} "
                f"ms a sweep")
            log_split(unit, levels, by_level(sweep, len(levels)))
            fill_ms = cuda_ms(lambda: [g.fill_(0.0) for g in got], iters)
            n_bytes = sum(g.numel() * 2 for g in got)
            log(f"  yardstick: fill_ of the {len(got)} bf16 cols tensors "
                f"({n_bytes / 1e6:.1f} MB): {fill_ms:.4f} ms, "
                f"{n_bytes / fill_ms / 1e9:.2f} TB/s")
        torch.cuda.empty_cache()
    return ins, wants, saved


def against(saved, path):
    """Log whether each saved digest equals the one in ``path``'s run."""
    ref = torch.load(path)
    for unit, regimes in saved.items():
        for regime, digs in regimes.items():
            other = ref[unit][regime]
            bad = [i for i, (a, b) in enumerate(zip(digs, other))
                   if a[0] != b[0]]
            log(f"bits against {path}: K1 bf16 {unit} {regime}: " + (
                "same" if not bad and len(digs) == len(other) else
                "DIFFER at levels " + ", ".join(
                    f"{i} (sampled max abs diff "
                    f"{float((digs[i][1] - other[i][1]).abs().max()):.3e})"
                    for i in bad)))


def bf16_variants(names):
    """{name: edited text} of this tree's ``deform_im2col.cu``: ``base``
    and the named variants ('a+b' applies both; all when empty)."""
    src = (native.CSRC_DIR / "deform_im2col.cu").read_text()
    out = {"base": src}
    for name in names or list(BF16_EDITS):
        text = src
        for part in name.split("+"):
            for edits in BF16_EDITS[part]:
                if all(old in text for old, _ in edits):
                    for old, new in edits:
                        text = text.replace(old, new)
                    break
            else:
                raise RuntimeError(f"{part}: deform_im2col.cu holds none of "
                                   f"its edit sets")
        out[name] = text
    return out


def time_bf16_variants(names, ins, wants, iters):
    """Each variant through its C entry at each unit (``far`` inputs): the
    sweep's CUDA-event ms (two turns), device ms by kernel and level, and
    the error against the plain version."""
    out_dir = native.BUILD_DIR.parent / "k1k6_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts, variants_built = bf16_variants(names), {}
    threads = [threading.Thread(target=build, args=(
        f"bf16:{n}", "deform_im2col", t, out_dir, variants_built))
        for n, t in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in texts:
        built = variants_built[f"bf16:{name}"]
        if not isinstance(built, tuple):
            raise RuntimeError(f"nvcc failed on bf16:{name}:\n{built}")
        lib = ctypes.CDLL(str(built[0].resolve()))
        fn = lib.deform_im2col_bf16
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [
            ctypes.c_void_p]
        log(f"variant bf16:{name}: {built[1]}")
        for unit, xs in ins.items():
            dev = xs[0][0].device
            stream = native.stream_ptr(dev)
            bufs = []
            for x, _ in xs:
                b, c, h, w = x.shape
                bufs.append((torch.empty((b * GROUPS, h * w, c // GROUPS),
                                         device=dev, dtype=x.dtype),
                             torch.zeros((b, 9 * c, h * w), device=dev,
                                         dtype=x.dtype)))

            def sweep(xs=xs, bufs=bufs):
                for (x, off), (xr, cols) in zip(xs, bufs):
                    b, c, h, w = x.shape
                    code = fn(x.data_ptr(), off.data_ptr(), xr.data_ptr(),
                              cols.data_ptr(), b, c, h, w, GROUPS, h, w, 3,
                              3, 1, 1, 1, int((c // GROUPS) % 8 == 0),
                              stream)
                    if code:
                        raise RuntimeError(f"bf16:{name}: CUDA error {code}")
            t1, t2 = cuda_ms(sweep, iters), cuda_ms(sweep, iters)
            sweep()
            err = rel_err([cols for _, cols in bufs], wants[unit])
            log(f"variant bf16:{name} {unit}: CUDA events {t1:.4f} / "
                f"{t2:.4f} ms a sweep, err vs plain {err:.3e}")
            log_split(f"bf16:{name} {unit}", BF16_UNITS[unit][0],
                      by_level(sweep, len(xs)))
            del bufs
            torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--against", help="compare bits with a saved run")
    ap.add_argument("--bf16", action="store_true",
                    help="the bf16 K1 alone, at the flagship's and the "
                    "544x544 levels")
    ap.add_argument("--variants", nargs="*", metavar="NAME",
                    help="time edited copies of this tree's K1 and K6 "
                    "sources (--bf16: of the bf16 K1): these ('a+b' "
                    "combines two), or all of them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k1k6_probe: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    log(f"package: {mask_assembly.__file__}")
    dev = torch.device("cuda", 0)
    for stem in SOURCES.values():
        native.load(stem)
    for name, (secs, ptxas) in native.BUILD_LOG.items():
        log(f"{name}: nvcc {secs:.1f} s; {ptxas_summary(ptxas)}")
    gen = torch.Generator().manual_seed(args.seed)
    if args.bf16:
        ins, wants, saved = bf16_base(dev, gen, args.iters)
        if args.save:
            torch.save(saved, args.save)
        if args.against:
            against(saved, args.against)
        if args.variants is not None:
            time_bf16_variants(args.variants, ins, wants, args.iters)
        return
    k1_in = k1_inputs(gen, dev)
    k6_in = {label: k6_inputs(*hwn, gen, dev)
             for label, hwn in K6_UNITS.items()}
    saved, want = {}, {}

    def k1_sweep():
        return [deform_sample.deform_im2col(x, o, (3, 3), 1, 1, 1, GROUPS)
                for x, o in k1_in]
    with torch.no_grad():
        got = k1_sweep()
        want["k1"] = [deform_sample.deform_im2col_plain(
            x, o, (3, 3), 1, 1, 1, GROUPS) for x, o in k1_in]
    t1, t2 = cuda_ms(k1_sweep, args.iters), cuda_ms(k1_sweep, args.iters)
    kern = split(k1_sweep)
    one = split(lambda: deform_sample.deform_im2col(*k1_in[0], (3, 3), 1, 1,
                                                    1, GROUPS))
    log(f"K1 deform_im2col 5 levels bs{BATCH}: CUDA events {t1:.4f} / "
        f"{t2:.4f} ms a sweep; device {sum(ms for _, ms in kern):.4f} ms: "
        + "; ".join(f"{n[:60]} {ms:.4f}" for n, ms in kern)
        + f"; one call at {LEVELS[0]}: {len(one)} device kernels; max abs "
        f"err vs plain "
        f"{max(max_abs(g, e) for g, e in zip(got, want['k1'])):.3e}")
    saved["k1"] = [g.cpu() for g in got]
    # yardstick: the same bytes written contiguously by a fill
    fill_ms = cuda_ms(lambda: [g.fill_(0.0) for g in got], args.iters)
    n_bytes = sum(g.numel() * 4 for g in got)
    log(f"yardstick: fill_ of the five cols tensors ({n_bytes / 1e6:.0f} "
        f"MB): {fill_ms:.4f} ms, {n_bytes / fill_ms / 1e9:.2f} TB/s")
    for label, (basis, cofs, boxes) in k6_in.items():
        def call(basis=basis, cofs=cofs, boxes=boxes):
            return mask_assembly.assemble_masks(basis, cofs, boxes)
        got = call()
        want[label] = mask_assembly.assemble_masks_plain(basis, cofs, boxes)
        t1, t2 = cuda_ms(call, args.iters), cuda_ms(call, args.iters)
        kern = split(call)
        log(f"K6 assemble_masks {label} bs{PP_BATCH}: CUDA events "
            f"{t1:.4f} / {t2:.4f} ms a call; {len(kern)} device kernels, "
            f"{sum(ms for _, ms in kern):.4f} ms: " + "; ".join(
                f"{n[:60]} {ms:.4f}" for n, ms in kern)
            + f"; max abs err vs plain {max_abs(got, want[label]):.3e}, "
            f"same zeros {bool(torch.equal(got == 0, want[label] == 0))}")
        saved[label] = got.contiguous().cpu()
    if args.save:
        torch.save(saved, args.save)
    if args.against:
        ref = torch.load(args.against)
        log("bits against " + args.against + ": K1 " + (
            "same" if all(torch.equal(a, b) for a, b in
                          zip(saved["k1"], ref["k1"])) else "DIFFER")
            + ", " + ", ".join(
                f"K6 {label} " + ("same" if torch.equal(saved[label],
                                                        ref[label])
                                  else f"DIFFER (max abs diff "
                                  f"{max_abs(saved[label], ref[label]):.3e})")
                for label in K6_UNITS))
    if args.variants is not None:
        time_variants(args.variants, k1_in, k6_in, want, args.iters)


if __name__ == "__main__":
    main()
