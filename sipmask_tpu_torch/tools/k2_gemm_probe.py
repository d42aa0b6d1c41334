"""Where K2's time goes, on one CUDA card:

    python -m sipmask_tpu_torch.tools.k2_gemm_probe
    python -m sipmask_tpu_torch.tools.k2_gemm_probe --bf16 [NAME ...]

from the root of the checkout. Builds edited copies of
``csrc/deform_col2im.cu`` (and of the shared header
``csrc/deform_corners.cuh``, where a variant edits it) into
``build/k2_probe/<variant>/``.

f32 (no flag): the two GEMMs of one K2 call at the FeatureAlign P3 level of
an 800x1344 image, batch 4 (``torch.profiler`` device time, mean of 5
calls):

- ``base``: the source as it is;
- ``one_mma``: only the big·big product of 3xTF32 (a third of the tensor
  work, the same loads, splits and flushes): how far the tensor cores bound
  the GEMMs;
- ``chain``: every product into one accumulator, no per-stage
  round-to-nearest flush: what the flush costs;
- ``stages4``: a ring of 4 stages instead of 3.

``--bf16``: a bf16 call at each of the five FeatureAlign levels of
800x1344, batch 4 (one sweep, as ``chip_smoke.py`` phase 19 times it):
device ms by kernel (mean of 5 sweeps), the GEMMs' TFLOP/s, and, for the
variants that compute K2, each output's error against the plain version
relative to its max, level by level, dW2's against an f32 product of the
kernel's own bf16 operands (``dw2_gemm``: the plain version samples its own
cols, whose bf16 roundings differ from K1's), and whether two calls give
the same dW2 and d offsets bits; each variant first with offsets of ~2 px
(a third of them +-300 px), then with zero offsets (integer positions, as
FeatureAlign's zero-initialised ``conv_offset`` gives: 3 of 4 corners of
zero weight). Variants (all without names):

- ``base``: the source as it is (wgmma GEMMs at every level, on padded
  copies of dy and cols where P % 8 != 0; the half-warp float4 scatter);
- ``mma``: the mma.sync GEMMs at every level (the GEMMs before wgmma);
- ``nopad``: mma.sync where P % 8 != 0, no copies;
- ``noflush``: the wgmma dW2 without its per-stage round-to-nearest
  flush: every stage into the accumulator, a group left in flight;
- ``storeonly``: the dcols GEMM with no loads of dy and no products, only
  its epilogue's stores (the write ceiling; not K2);
- ``float2``: the warp-per-pixel float2 scatter in place of the float4 one;
- ``noskip``: the float4 scatter without its skip of zero-weight corners.

``--sass`` also counts the HGMMA (wgmma) instructions of each function of
the ``base`` build. The first line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import threading
from pathlib import Path

import torch

from ..ops import native

OUT = native.BUILD_DIR.parent / "k2_probe"
B, C, H, W, G, O = 4, 256, 100, 168, 4, 256   # P3 of 800x1344, batch 4


def variants(src: str):
    def edit(old, new):
        if old not in src:
            raise RuntimeError(f"deform_col2im.cu no longer has {old!r}")
        return src.replace(old, new)
    return {
        "base": src,
        "one_mma": edit(
            "        for (int j = 0; j < kNT; ++j)\n"
            "          mma_tf32(part[i][j], a_small, b_big[j]);\n"
            "#pragma unroll\n"
            "        for (int j = 0; j < kNT; ++j)\n"
            "          mma_tf32(part[i][j], a_big, b_small[j]);\n"
            "#pragma unroll\n", ""),
        "chain": edit("mma_tf32(part[i][j]", "mma_tf32(acc[i][j]"),
        "stages4": edit("constexpr int kStages = 3;",
                        "constexpr int kStages = 4;"),
    }


def bf16_variants(src: str, header: str):
    """name -> the edited source, or (source, {header name: edited
    header}) where the edit lies in a shared header."""
    def edit(text, old, new):
        if text.count(old) != 1:
            raise RuntimeError(f"the source has {old!r} "
                               f"{text.count(old)} times, not once")
        return text.replace(old, new)

    def edits(text, pairs):
        for old, new in pairs:
            text = edit(text, old, new)
        return text
    return {
        "base": src,
        "mma": edit(src, "int r = wg::route(P, KC, K * Cg, O);",
                    "int r = wg::kMma;"),
        "nopad": edit(src, "return P % 8 == 0 ? kWgmma : kPadded;",
                      "return P % 8 == 0 ? kWgmma : kMma;"),
        "noflush": edits(src, [
            ("      for (int i = 0; i < 64; ++i) acc[i] = 0.f;\n",
             "      for (int i = 0; i < 64; ++i) acc[i] = 0.f;\n"
             "      int prev = 0;\n"),
            ("wgmma_m64n128_k(part, desc_sw128(a + kk * 32, 16, 1024),\n"
             "                          desc_sw128(b + kk * 32, 16, 1024), "
             "kk);\n        wgmma_commit();\n        wgmma_wait<0>();\n"
             "        fence_regs(part);\n"
             "        if (lane == 0) mbar_arrive(empty + 8 * s);\n",
             "wgmma_m64n128_k(acc, desc_sw128(a + kk * 32, 16, 1024),\n"
             "                          desc_sw128(b + kk * 32, 16, 1024), "
             "1);\n        wgmma_commit();\n"
             "        if (k > k0) {   // one group in flight\n"
             "          wgmma_wait<1>();\n"
             "          if (lane == 0) mbar_arrive(empty + 8 * prev);\n"
             "        }\n        prev = s;\n"),
            ("for (int i = 0; i < 64; ++i) acc[i] += part[i];",
             "for (int i = 0; i < 64; ++i) (void)part[i];"),
            ("      }\n      // thread (warp, lane) holds rows 16*warp",
             "      }\n      wgmma_wait<0>();\n      fence_regs(acc);\n"
             "      if (lane == 0) mbar_arrive(empty + 8 * prev);\n"
             "      __syncwarp();\n"
             "      // thread (warp, lane) holds rows 16*warp")]),
        "storeonly": edit(edit(
            src, "dcols_load_tile(&tm_dy, ring, full, empty, p.ks, m0, image, "
            "s, ph);", "(void)m0;"),
            "dcols_mainloop(acc, ring, bres, full, empty, p.ks, c, lane, s, "
            "ph);", "(void)lane;"),
        "float2": edit(src, "if (kBf16 && Cg % 4 == 0)", "if (false)"),
        "noskip": (src, {"deform_corners.cuh": edit(
            header, "return valid && w != 0.f;", "return valid;")}),
    }


def build(name, text, built):
    """Build ``text`` (a source, or (source, {header name: text})) in a
    directory of its own: an edited header there shadows csrc's."""
    text, headers = text if isinstance(text, tuple) else (text, {})
    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    for header, body in headers.items():
        (out / header).write_text(body)
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    lines = res.stderr.splitlines()
    for i, line in enumerate(lines):   # the wgmma kernels' registers
        if "Compiling entry" in line and "wgmma" in line:
            kernel = "dcols" if "dcols" in line else "dW2"
            print(f"{name}: wgmma {kernel}: "
                  + " ".join(l.strip() for l in lines[i + 2:i + 4]),
                  flush=True)
    built[name] = so


def scratch_floats(lib):
    """(b, o, kc, p, bf16) -> the floats of a call's scratch."""
    fn = lib.deform_conv_bwd_scratch_floats
    fn.restype, fn.argtypes = ctypes.c_longlong, [ctypes.c_int] * 7
    return lambda b, o, kc, p, bf16: fn(b, o, G, 9, kc // (9 * G), p,
                                        int(bf16))


def gemm_ms(lib, dev):
    """Device ms of each GEMM launch of one K2 call, mean of 5 calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator().manual_seed(0)
    kc, p = 9 * C, H * W
    x = torch.randn((B, C, H, W), generator=gen).to(dev)
    off = (torch.randn((B, G * 18, H, W), generator=gen) * 2).to(dev)
    cols = torch.randn((B, kc, p), generator=gen).to(dev)
    w2 = (torch.randn((O, kc), generator=gen) * 0.01).to(dev)
    dy = torch.randn((B, O, p), generator=gen).to(dev)
    fn = lib.deform_conv_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    parts = scratch_floats(lib)(B, O, kc, p, False)
    bufs = [torch.empty_like(x), torch.empty((B * G, p, kc // G), device=dev),
            torch.empty((parts,), device=dev), torch.empty_like(x),
            torch.empty_like(x), torch.empty_like(off), torch.empty_like(w2)]

    def call():
        code = fn(*(t.data_ptr() for t in (x, off, cols, w2, dy, *bufs)),
                  B, C, H, W, G, H, W, 3, 3, 1, 1, 1, O,
                  native.stream_ptr(dev))
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)   # the first kernel can go unrecorded
        torch.cuda.synchronize()
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "gemm" in e.name:
            key = "dcols" if "<false, false>" in e.name else "dW2"
            ms[key] = ms.get(key, 0.0) + e.device_time / 5e3
    return ms


LEVELS = [(100, 168), (50, 84), (25, 42), (13, 21), (7, 11)]  # 800x1344


def bf16_case(lib, dev, zero):
    """Per level: the bf16 inputs (offsets ~2 px with a third +-300 px, or
    with ``zero`` all zero: integer positions, where the scatter skips 3 of
    4 corners), K1's cols, the plain outputs and the scratch of a call (as
    ``deform_conv_backward`` allocates it)."""
    from ..ops import deform_conv, deform_sample
    gen = torch.Generator().manual_seed(0)
    bf, kc = torch.bfloat16, 9 * C
    floats = scratch_floats(lib)
    case = []
    for h, w in LEVELS:
        x = torch.randn((B, C, h, w), generator=gen).to(dev).to(bf)
        off = torch.randn((B, G * 18, h, w), generator=gen) * 2
        off.view(B, G * 18, h * w)[:, :, :(h * w) // 3] *= 150.0
        off = (off * (not zero)).to(dev)
        w2 = (torch.randn((O, kc), generator=gen) * 0.01).to(dev).to(bf)
        dy = torch.randn((B, O, h, w), generator=gen).to(dev).to(bf)
        cols = deform_sample.deform_im2col(x, off, (3, 3), 1, 1, 1, G)
        want = deform_conv.deform_conv_backward_plain(x, off, w2, dy, (3, 3),
                                                      1, 1, 1, G)
        # dW2 of the kernel's own operands, f32 products and sums
        want = want + (torch.matmul(dy.reshape(B, O, -1).float(),
                                    cols.float().transpose(1, 2)).sum(0),)
        parts = floats(B, O, kc, h * w, True)
        bufs = [torch.empty_like(x), torch.empty((B * G, h * w, kc // G),
                                                 device=dev, dtype=bf),
                torch.empty((parts,), device=dev),
                torch.empty_like(x, dtype=torch.float32), torch.empty_like(x),
                torch.empty_like(off), torch.empty_like(w2, dtype=torch.float32)]
        case.append(((x, off, cols, w2, dy), bufs, want, (B, h, w)))
    return case


def bf16_sweep(lib, dev, case, keep=False):
    """A function that makes one bf16 call per level of ``case``; with
    ``keep``, returning copies of (dx, d offsets, dw2) of each."""
    fn = lib.deform_conv_bwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]

    def call(ins, bufs, bhw):
        b, h, w = bhw
        code = fn(*(t.data_ptr() for t in (*ins, *bufs)), b, C, h, w, G,
                  h, w, 3, 3, 1, 1, 1, O, native.stream_ptr(dev))
        if code:
            raise RuntimeError(f"launch failed: CUDA error {code}")
        return tuple(bufs[i].clone() for i in (4, 5, 6)) if keep else None

    def sweep():
        return [call(ins, bufs, bhw) for ins, bufs, _, bhw in case]
    return sweep


def bf16_errors(name, lib, dev, case):
    """Each output's error against the plain version (relative to its max)
    level by level, dW2's against the f32 product of its own operands, and
    whether two calls give the same dW2 and d offsets bits."""
    sweep = bf16_sweep(lib, dev, case, keep=True)
    first, second = sweep(), sweep()
    torch.cuda.synchronize()
    errs = []
    for (got, again), (_, _, want, bhw) in zip(zip(first, second), case):
        rel = [float((g.float() - w.float()).abs().max())
               / max(float(w.float().abs().max()), 1e-30)
               for g, w in zip(got + got[2:], want)]
        same = (torch.equal(got[1], again[1]), torch.equal(got[2], again[2]))
        errs.append(f"b{bhw[0]} {bhw[1]}x{bhw[2]} dx {rel[0]:.3e} doff "
                    f"{rel[1]:.3e} dw2 {rel[2]:.3e} dw2_gemm {rel[3]:.3e} "
                    f"same bits (doff, dw2) {same}")
    print(f"{name}: errors to max |plain|: " + "; ".join(errs), flush=True)


def kernel_name(name: str) -> str:
    """A device kernel's function name with its template arguments, without
    namespaces and parameters ("Memset" etc. as they are)."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("(")[0].replace("wg::", "").replace(
        "__nv_bfloat16", "bf16").strip()


def bf16_probe(label, name, lib, dev, case):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if name != "storeonly":
        bf16_errors(label, lib, dev, case)
    sweep = bf16_sweep(lib, dev, case)
    sweep()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)   # the first kernel can go unrecorded
        torch.cuda.synchronize()
        for _ in range(5):
            sweep()
        torch.cuda.synchronize()
    ms, seen = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name:
            key = kernel_name(e.name)
            ms[key] = ms.get(key, 0.0) + e.device_time / 5e3
            seen += 1
    flops = sum(4 * B * 9 * C * O * h * w for h, w in LEVELS)
    gemm = sum(v for k, v in ms.items() if "gemm" in k)
    print(f"{label}: {seen} kernels seen in 5 sweeps; device ms a sweep "
          f"{sum(ms.values()):.4f}; GEMMs "
          f"{gemm:.4f} ({flops / max(gemm, 1e-9) / 1e9:.1f} TFLOP/s of bf16 "
          f"products); " + "; ".join(f"{k} {v:.4f}" for k, v in
                                     sorted(ms.items(), key=lambda kv: -kv[1])),
          flush=True)


def hgmma(so: Path):
    """Print the HGMMA instructions of each function of a built library."""
    tool = Path(native.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    counts, func = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            func = line.split("Function : ")[1].strip()
        elif func and "HGMMA" in line:
            counts[func] = counts.get(func, 0) + 1
    for func, n in counts.items():
        print(f"HGMMA x{n} in {func}", flush=True)
    print(f"{len(counts)} functions with HGMMA", flush=True)


def build_all(texts):
    built = {}
    threads = [threading.Thread(target=build, args=(n, t, built))
               for n, t in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    missing = [n for n in texts if n not in built]
    if missing:
        raise RuntimeError(f"{missing} did not build")
    return {n: ctypes.CDLL(str(Path(built[n]).resolve())) for n in texts}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", nargs="*", default=None, metavar="NAME",
                    help="the bf16 variants (all without names)")
    ap.add_argument("--sass", action="store_true",
                    help="count the HGMMA (wgmma) instructions of each "
                         "function of the base build (cuobjdump -sass)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k2_gemm_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    src = (native.CSRC_DIR / "deform_col2im.cu").read_text()
    dev = torch.device("cuda", 0)
    if args.bf16 is not None:
        texts = bf16_variants(
            src, (native.CSRC_DIR / "deform_corners.cuh").read_text())
        names = args.bf16 or list(texts)
        libs = build_all({f"bf16_{n}": texts[n] for n in names})
        if args.sass and "base" in names:
            hgmma(OUT / "bf16_base" / "bf16_base.so")
        for zero in (False, True):
            case = bf16_case(libs[f"bf16_{names[0]}"], dev, zero)
            for n in names:
                bf16_probe(f"{n} {'zero' if zero else 'random'} offsets",
                           n, libs[f"bf16_{n}"], dev, case)
            del case
        return
    texts, built = variants(src), {}
    threads = [threading.Thread(target=build, args=(n, t, built))
               for n, t in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dev = torch.device("cuda", 0)
    flops = 2 * B * 9 * C * O * H * W   # one GEMM in f32
    for name in texts:
        if name not in built:
            raise RuntimeError(f"{name} did not build")
        ms = gemm_ms(ctypes.CDLL(str(Path(built[name]).resolve())), dev)
        print(f"{name}: " + ", ".join(
            f"{k} {v:.4f} ms ({flops / v / 1e9:.1f} TFLOP/s of f32 products)"
            for k, v in sorted(ms.items())), flush=True)


if __name__ == "__main__":
    main()
