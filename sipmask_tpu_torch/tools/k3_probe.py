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
run's. ``--variants`` then builds edited copies of ``csrc/mask_bce.cu`` into
``build/k3_probe/`` and times a K3a call of each on the same inputs (CUDA
events, two turns, and the error against the plain version), to see what
bounds its tile kernel; ``base`` is the source as it is, and ``noshfl`` and
``dot4`` compute something else, for timing only:

- ``nolb``: no register cap (``__launch_bounds__`` without 2 blocks an SM);
- ``noshfl``: no warp shuffles (each warp keeps lane 0's term);
- ``fastbce``: the BCE's ``log1pf(expf(.))`` as ``__logf(1 + __expf(.))``;
  ``fastexp``: as ``log1pf(__expf(.))``; ``fastlog``: as
  ``__logf(1 + expf(.))``;
- ``bytes``: each (pixel, positive) reads its gt byte, as for G > 64;
- ``noshare``: the two rows of a warp read their coefficients apart;
- ``dot4``: a 4-term dot in place of the 32-term one.
"""

from __future__ import annotations

import argparse
import ctypes
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


def variants(src):
    def edit(old, new):
        if old not in src:
            raise RuntimeError(f"mask_bce.cu no longer has {old!r}")
        return src.replace(old, new)
    return {
        "base": src,
        "nolb": edit("__launch_bounds__(kThreads, 2) mask_bce_fwd_tiles",
                     "__launch_bounds__(kThreads) mask_bce_fwd_tiles"),
        "noshfl": edit("t = warp_sum(e);", "t = e;"),
        "fastbce": edit("log1pf(expf(-fabsf(s)))",
                        "__logf(1.f + __expf(-fabsf(s)))"),
        "fastexp": edit("log1pf(expf(-fabsf(s)))",
                        "log1pf(__expf(-fabsf(s)))"),
        "fastlog": edit("log1pf(expf(-fabsf(s)))",
                        "__logf(1.f + expf(-fabsf(s)))"),
        "bytes": edit("auto kernel = G <= 64 ?", "auto kernel = G <= 0 ?"),
        "noshare": edit("if (q0 == q1)  // uniform over the warp",
                        "if (false)"),
        "dot4": edit("for (int m = 0; m < NB / 4; ++m) {",
                     "for (int m = 0; m < 1; ++m) {"),
    }


def build_variant(name, text, out, built):
    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(text)
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    built[name] = (so, " | ".join(
        ln.strip() for ln in res.stderr.splitlines()
        if ("registers" in ln or "spill" in ln) and ln))


def time_variants(ins, want, iters):
    """CUDA-event ms of a K3a call of each variant, two turns, and its
    error against ``want``."""
    out = native.BUILD_DIR.parent / "k3_probe"
    out.mkdir(parents=True, exist_ok=True)
    texts, built = variants((native.CSRC_DIR / "mask_bce.cu").read_text()), {}
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
    for name in texts:
        if name not in built:
            raise RuntimeError(f"{name} did not build")
        lib = ctypes.CDLL(str(built[name][0].resolve()))
        lib.mask_bce_fwd_scratch.restype = ctypes.c_int64
        lib.mask_bce_fwd_scratch.argtypes = [ctypes.c_int] * 4
        fn = lib.mask_bce_fwd_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        part = torch.empty((lib.mask_bce_fwd_scratch(b, k, h, w),),
                           device=basis.device)

        def call():
            code = fn(*(t.data_ptr() for t in (basis, cofs, boxes, gt, idx,
                                               vld, part, pre)),
                      b, k, g, h, w, native.stream_ptr(basis.device))
            if code:
                raise RuntimeError(f"{name}: CUDA error {code}")
        t1, t2 = cuda_ms(call, iters), cuda_ms(call, iters)
        log(f"variant {name}: CUDA events {t1:.4f} / {t2:.4f} ms a call; "
            f"error vs plain {rel_err(pre, want):.3e}; {built[name][1]}")


def rel_err(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()),
                                                 1e-30)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--save", help="write the outputs here (torch.save)")
    ap.add_argument("--against", help="compare bits with a saved run")
    ap.add_argument("--variants", action="store_true",
                    help="time edited copies of the K3a kernel")
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
        log(f"{name}: nvcc {secs:.1f} s; " + " | ".join(
            ln.strip() for ln in ptxas.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln))
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
            f"diff {float((v - ref[k]).abs().max()):.3e})"
            for k, v in saved.items()))
    if args.variants:
        time_variants(ins, want_pre, args.iters)


if __name__ == "__main__":
    main()
