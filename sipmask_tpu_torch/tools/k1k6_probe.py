"""K1 (deformable im2col, ``csrc/deform_im2col.cu``) and K6 (SP mask
assembly, ``csrc/mask_assembly.cu``) at their smoke units on one CUDA card,
and edited copies of both, to see what bounds them:

    PYTHONPATH=<tree> python <this file> [--save out.pt] [--against ref.pt]
        [--variants [NAME ...]]

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

``--variants`` builds edited copies of this tree's two sources into
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
import re
import subprocess
import threading
from pathlib import Path

import torch

from sipmask_tpu_torch.ops import deform_sample, mask_assembly, native

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
    "k1:notranspose": [("  deform_im2col_rows_kernel<<<tgrid, kThreads, 0, "
                        "s>>>(\n      (const float*)x, (float*)x_rows, Cg, "
                        "HW);\n", "")],
    "k1:transposeonly": [("  const bool out4 = (Ho * Wo) % 4 == 0;",
                          "  if (BG > 0) return 0;\n"
                          "  const bool out4 = (Ho * Wo) % 4 == 0;")],
    "k1:cgrt": [("  if (vec4 && Cg == 64)", "  if (false)")],
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
    "k1:vec1": [("  if (vec4 && Cg == 64)", "  if (false)"),
                ("  else if (vec4 && Cg % 4 == 0)", "  else if (false)")],
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
        if m:
            kernel = m.group(1)[-40:]
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
                text = text.replace(old, new)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--against", help="compare bits with a saved run")
    ap.add_argument("--variants", nargs="*", metavar="NAME",
                    help="time edited copies of this tree's K1 and K6 "
                    "sources: these ('a+b' combines two), or all of them")
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
