"""K3a and K3b (the SP mask loss, ``ops/mask_loss.py``) at the flagship's
train-step unit on one CUDA card, for comparing two trees on one card:

    PYTHONPATH=<tree> python <this file> --save out.pt [--against ref.pt]

The package is imported from ``<tree>`` (a checkout, or an unpacked
``git archive`` of another commit), and its kernels build there. Inputs
are ``chip_smoke.py``'s K3 inputs: 32 bases on the 400x672 mask grid, K =
512 positives with boxes covering 5-60% of the map (a fifth invalid), 64 gt
masks, batch 4, a cotangent with zeros; from ``--seed``. Prints the card's
name and power limit, then for each of K3a and K3b: the CUDA-event ms of a
call (two turns), the device kernels of one call with their ms
(``torch.profiler``), whether two calls give the same bits, and the error
against the plain version relative to each output's max |value|. ``--save``
writes the outputs; ``--against`` compares them bit for bit with a saved
run's (the largest difference of each output relative to its max |value|
where the bits differ). ``--variants [NAME ...]`` then builds edited
copies of ``csrc/mask_bce.cu`` into ``build/k3_probe/`` (all of them, or the
named ones; ``a+b`` applies both) and times a K3a and a K3b call of each on
the same inputs (CUDA events, two turns, and the errors against the plain
versions), to see what bounds the tile kernels; ``base`` is the source as
it is, and ``noshfl``, ``dot4``, ``nors`` and ``dbnolds`` compute something
else, for timing only:

- ``nolb``: no register cap on K3a's tile kernel (``__launch_bounds__``
  without 2 blocks an SM);
- ``noshfl``: no warp shuffles in K3a (each warp keeps lane 0's term);
- ``fastbce``: the BCE's ``log1pf(expf(.))`` as ``__logf(1 + __expf(.))``;
  ``fastexp``: as ``log1pf(__expf(.))``; ``fastlog``: as
  ``__logf(1 + expf(.))``;
- ``bytes``: each (pixel, positive) reads its gt byte, as for G > 64;
- ``noshare``: the two rows of a K3a warp read their coefficients apart;
- ``dot4``: a 4-term dot in place of the 32-term one (every kernel);
- ``libmsig``: K3b's sigmoid as ``1 / (1 + expf(-s))`` (libm);
- ``sub4``, ``sub16``: K3b's d cofs kernel folds the warps' sums of 4 or
  16 hits at a time (8 as built); ``red2``: two such buffers, one barrier
  a fold;
- ``db8``, ``db16``: d basis blocks of 8 or 16 rows (4 as built: 4 blocks
  an SM);
- ``nocreg``: d basis reads a hit's coefficients from shared memory for
  the dot and again for the update;
- ``rsserial``: d cofs' reduce-scatter halvings slot by slot, not each
  halving's shuffles together;
- ``carve``: d cofs prefers the largest shared-memory carveout;
- ``dc1``: d cofs at 1 block an SM, registers uncapped;
- ``noinline``: the backward's staging as a called function;
- ``nors``: d cofs without its reduce-scatter (lane 0's slot);
- ``dbnolds``: d basis's update without its coefficients.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import threading

import torch

from sipmask_tpu_torch.ops import mask_loss, native

MASK_HW, MAX_POS, MAX_GTS, BATCH = (400, 672), 512, 64, 4


def log(*args):
    print(*args, flush=True)


def k3_inputs(b, gen, dev):
    """As ``chip_smoke.k3_inputs``."""
    h, w = MASK_HW
    basis = torch.randn((b, 32, h, w), generator=gen)
    cofs = torch.randn((b, MAX_POS, 128), generator=gen) * 0.3
    frac = torch.sqrt(torch.rand((b, MAX_POS, 1), generator=gen) * 0.55
                      + 0.05)
    wh = frac * torch.tensor([w, h], dtype=torch.float32)
    ctr = torch.rand((b, MAX_POS, 2), generator=gen) * torch.tensor(
        [w, h], dtype=torch.float32)
    boxes = torch.cat([ctr - wh / 2, ctr + wh / 2], -1)
    gt = (torch.rand((b, MAX_GTS, h, w), generator=gen) > 0.5).to(
        torch.uint8)
    gt_idx = torch.randint(0, MAX_GTS, (b, MAX_POS), generator=gen)
    valid = torch.rand((b, MAX_POS), generator=gen) > 0.2
    grad = torch.rand((b, MAX_POS), generator=gen)
    grad[:, ::5] = 0.0
    return ([t.to(dev) for t in (basis, cofs, boxes, gt, gt_idx, valid)],
            grad.to(dev))


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
    ``attempts`` profiler sessions (each behind a marker kernel: the
    profiler in the card's sandbox sometimes misses a session's first
    kernel)."""
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


# reduce_scatter's halvings as built, and slot by slot (t[i] from slots
# i + 4j, fewer sums live at once)
RS_WIDE = """  float t[16];
#pragma unroll
  for (int s = 0; s < 16; ++s)
    t[s] = fmaf(a, va[s], b * vb[s]) +
           __shfl_xor_sync(kFull, fmaf(a, va[s + 16], b * vb[s + 16]), 16);
#pragma unroll
  for (int s = 0; s < 8; ++s) t[s] += __shfl_xor_sync(kFull, t[s + 8], 8);
  float t4[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    t4[s] = t[s] + __shfl_xor_sync(kFull, t[s + 4], 4);"""
RS_SERIAL = """  float t4[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t1[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int s = i + 4 * h + 8 * e;
        t1[e] = fmaf(a, va[s], b * vb[s]) +
                __shfl_xor_sync(kFull, fmaf(a, va[s + 16], b * vb[s + 16]),
                                16);
      }
      t2[h] = t1[0] + __shfl_xor_sync(kFull, t1[1], 8);
    }
    t4[i] = t2[0] + __shfl_xor_sync(kFull, t2[1], 4);
  }"""


def variant_edits():
    """Each variant's edits of ``csrc/mask_bce.cu``, (old, new) pairs."""
    return {
        "nolb": [("__launch_bounds__(kThreads, 2) mask_bce_fwd_tiles",
                  "__launch_bounds__(kThreads) mask_bce_fwd_tiles")],
        "noshfl": [("t = warp_sum(e);", "t = e;")],
        "fastbce": [("log1pf(expf(-fabsf(s)))",
                     "__logf(1.f + __expf(-fabsf(s)))")],
        "fastexp": [("log1pf(expf(-fabsf(s)))", "log1pf(__expf(-fabsf(s)))")],
        "fastlog": [("log1pf(expf(-fabsf(s)))",
                     "__logf(1.f + expf(-fabsf(s)))")],
        "bytes": [("auto kernel = G <= 64 ?", "auto kernel = G <= 0 ?")],
        "noshare": [("if (q0 == q1)  // uniform over the warp", "if (false)")],
        "dot4": [("for (int m = 0; m < NB / 4; ++m) {\n    const float4 c",
                  "for (int m = 0; m < 1; ++m) {\n    const float4 c")],
        "libmsig": [("return __fdividef(1.f, 1.f + __expf(-s));",
                     "return 1.f / (1.f + expf(-s));")],
        "sub4": [("constexpr int kSub = 8;", "constexpr int kSub = 4;")],
        "sub16": [("constexpr int kSub = 8;", "constexpr int kSub = 16;")],
        "db8": [("constexpr int kDbRows = 4;", "constexpr int kDbRows = 8;")],
        "db16": [("constexpr int kDbRows = 4;",
                  "constexpr int kDbRows = 16;")],
        "nocreg": [("const float4* cs = reinterpret_cast<const float4*>(\n"
                    "          st.cofs + (j * 4 + q) * kQStride);\n"
                    "      float4 c[NB / 4];\n#pragma unroll\n"
                    "      for (int m = 0; m < NB / 4; ++m) c[m] = cs[m];",
                    "const float4* c = reinterpret_cast<const float4*>(\n"
                    "          st.cofs + (j * 4 + q) * kQStride);")],
        "rsserial": [(RS_WIDE, RS_SERIAL)],
        "carve": [("  dc_kernel<<<grid",
                   "  cudaFuncSetAttribute(dc_kernel, "
                   "cudaFuncAttributePreferredSharedMemoryCarveout, 100);\n"
                   "  dc_kernel<<<grid")],
        "dc1": [("__launch_bounds__(kThreads, 2) mask_bce_dcofs_tiles",
                 "__launch_bounds__(kThreads, 1) mask_bce_dcofs_tiles")],
        "noinline": [("__device__ __forceinline__ int stage_chunk(",
                      "__device__ __noinline__ int stage_chunk(")],
        "red2": [("float* red = smem + kStageFloats;",
                  "float* red2 = smem + kStageFloats;"),
                 ("      const int jn = min(kSub, nhit - j0);\n",
                  "      const int jn = min(kSub, nhit - j0);\n"
                  "      float* red = red2 + ((j0 / kSub) & 1) * (kSub * "
                  "kWarps * 4 * NB);\n"),
                 ("      __syncthreads();  // red is written again\n", ""),
                 ("(kStageFloats + kSub * kWarps * 4 * NB) * 4",
                  "(kStageFloats + 2 * kSub * kWarps * 4 * NB) * 4")],
        "nors": [("t = reduce_scatter(q0 == q ? d0 : 0.f, v0, q1 == q ? d1 : "
                  "0.f,\n                               v1, lane);",
                  "t = (q0 == q ? d0 : 0.f) * v0[0] + (q1 == q ? d1 : 0.f) * "
                  "v1[0];")],
        "dbnolds": [("const float4 cm = c[m];\n        acc[4 * m]",
                     "const float4 cm = make_float4(v[4 * m], v[4 * m + 1], "
                     "v[4 * m + 2], v[4 * m + 3]);\n        acc[4 * m]")],
    }


def variants(src, names=None):
    """{name: edited source}: ``base`` (the source as it is) and the named
    variants (all when ``names`` is None); 'a+b' applies a's edits, then
    b's."""
    edits = variant_edits()
    out = {"base": src}
    for name in names if names is not None else list(edits):
        text = src
        for part in name.split("+"):
            for old, new in edits[part]:
                if old not in text:
                    raise RuntimeError(f"{part}: mask_bce.cu no longer has "
                                       f"{old!r}")
                text = text.replace(old, new)
        out[name] = text
    return out


def ptxas_summary(report):
    """Each kernel's registers and spills from an ``nvcc -Xptxas -v``
    report, one item a kernel: 'dcofs_tiles<1> 128 regs, 0 B spilled'."""
    items, kernel = [], "?"
    for ln in report.splitlines():
        m = re.search(r"\dmask_bce_(\w+?)_kernel(?:ILb([01])E)?", ln)
        if "Compiling entry" in ln and m:
            kernel = m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m:
            spilled = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            items.append(f"{kernel} {m.group(1)} regs, {spilled} B spilled")
    return "; ".join(items)


def build_variant(name, text, out, built):
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    built[name] = (so, ptxas_summary(res.stderr))


def time_variants(ins, grad, want, iters, names=None):
    """CUDA-event ms of a K3a and a K3b call of each variant, two turns
    each, and their errors against ``want`` (pre, dbasis, dcofs)."""
    out = native.BUILD_DIR.parent / "k3_probe"
    out.mkdir(parents=True, exist_ok=True)
    texts = variants((native.CSRC_DIR / "mask_bce.cu").read_text(), names)
    built = {}
    threads = [threading.Thread(target=build_variant, args=(n, t, out, built))
               for n, t in texts.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    basis, cofs, boxes, gt, gt_idx, valid = ins
    b, _, h, w = basis.shape
    k, g = cofs.shape[1], gt.shape[1]
    idx, vld = gt_idx.to(torch.int64), valid.view(torch.uint8)
    pre = torch.empty((b, k), device=basis.device)
    db, dc = torch.empty_like(basis), torch.empty_like(cofs)
    for name in texts:
        if name not in built:
            raise RuntimeError(f"{name} did not build")
        lib = ctypes.CDLL(str(built[name][0].resolve()))
        for fn in (lib.mask_bce_fwd_scratch, lib.mask_bce_bwd_scratch):
            fn.restype, fn.argtypes = ctypes.c_int64, [ctypes.c_int] * 4
        fwd, bwd = lib.mask_bce_fwd_f32, lib.mask_bce_bwd_f32
        fwd.restype = bwd.restype = ctypes.c_int
        fwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        bwd.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        part = torch.empty((max(lib.mask_bce_fwd_scratch(b, k, h, w),
                                lib.mask_bce_bwd_scratch(b, k, h, w)),),
                           device=basis.device)
        stream = native.stream_ptr(basis.device)

        def check(code):
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")

        def k3a():
            check(fwd(*(t.data_ptr() for t in (basis, cofs, boxes, gt, idx,
                                               vld, part, pre)),
                      b, k, g, h, w, stream))

        def k3b():
            check(bwd(*(t.data_ptr() for t in (basis, cofs, boxes, gt, idx,
                                               vld, grad, part, db, dc)),
                      b, k, g, h, w, stream))
        a1, a2 = cuda_ms(k3a, iters), cuda_ms(k3a, iters)
        b1, b2 = cuda_ms(k3b, iters), cuda_ms(k3b, iters)
        log(f"variant {name}: K3a {a1:.4f} / {a2:.4f} ms a call, error vs "
            f"plain {rel_err(pre, want[0]):.3e}; K3b {b1:.4f} / {b2:.4f} ms, "
            f"errors {rel_err(db, want[1]):.3e}, {rel_err(dc, want[2]):.3e}"
            f"; {built[name][1]}")


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--against", help="compare bits with a saved run")
    ap.add_argument("--variants", nargs="*", metavar="NAME",
                    help="time edited copies of the K3 kernels: these "
                    "('a+b' combines two), or all of them")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_probe: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    log(f"package: {mask_loss.__file__}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    native.load("mask_bce")
    for name, (secs, ptxas) in native.BUILD_LOG.items():
        log(f"{name}: nvcc {secs:.1f} s; {ptxas_summary(ptxas)}")
    ins, grad = k3_inputs(BATCH, torch.Generator().manual_seed(args.seed),
                          dev)
    unit = f"{MASK_HW} K={MAX_POS} G={MAX_GTS} bs{BATCH}"
    calls = {
        "K3a mask_bce_forward": lambda: (mask_loss.mask_bce_forward(*ins),),
        "K3b mask_bce_backward": lambda: mask_loss.mask_bce_backward(*ins,
                                                                     grad),
    }
    out = {}
    for label, fn in calls.items():
        first, second = fn(), fn()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        t1, t2 = cuda_ms(fn, args.iters), cuda_ms(fn, args.iters)
        kern = split(fn)
        log(f"{label} {unit}: CUDA events {t1:.4f} / {t2:.4f} ms a call; "
            f"same bits twice: {same}; {len(kern)} device kernels, "
            f"{sum(ms for _, ms in kern):.4f} ms: " + "; ".join(
                f"{n[:60]} {ms:.4f} ms" for n, ms in kern))
        out[label] = [t.cpu() for t in first]
    with torch.no_grad():
        want_pre = mask_loss.mask_bce_loss_plain(*ins)
    want_db, want_dc = mask_loss.mask_bce_backward_plain(*ins, grad)
    (pre,), (db, dc) = out.values()
    log(f"errors vs plain, relative to max |value|: pre "
        f"{rel_err(pre, want_pre.cpu()):.3e}, dbasis "
        f"{rel_err(db, want_db.cpu()):.3e}, dcofs "
        f"{rel_err(dc, want_dc.cpu()):.3e}")
    saved = {"pre": pre, "dbasis": db, "dcofs": dc}
    if args.save:
        torch.save(saved, args.save)
    if args.against:
        ref = torch.load(args.against)
        log("bits against " + args.against + ": " + ", ".join(
            f"{k} {'same' if torch.equal(v, ref[k]) else 'DIFFER'} (max abs "
            f"diff {float((v - ref[k]).abs().max()):.3e}, relative to max "
            f"|value| {rel_err(v, ref[k]):.3e})" for k, v in saved.items()))
    if args.variants is not None:
        time_variants(ins, grad, (want_pre, want_db, want_dc), args.iters,
                      args.variants or None)


if __name__ == "__main__":
    main()
