"""K4a and K4b, the GroupNorm+ReLU forward and backward
(``csrc/gn_relu.cu``), and edited copies of it, on one CUDA card:

    python -m sipmask_tpu_torch.tools.k4a_probe [--dtype bfloat16] \\
        [--backward] [--variants [NAME ...]]

Inputs are ``tools/measure.py k4a``'s shapes: one GN site of each of the
flagship's five FPN levels at batch 4 (800x1344), 256 channels, 32 groups,
x ~ 3 N(0, 1) + 1, weight in [0.5, 1.5), bias ~ 0.2 N(0, 1), with the
statistics kept (``--backward``: K4b, with the ReLU, on a cotangent
~ N(0, 1)). Builds edited copies of the source into ``build/k4a_probe/``
(all, or the named ones), then prints the card's name and power limit and,
for the source as built (``base``) and each copy, each level's plan (the
C entry's own ``gn_relu_bf16_plan``: one pass or two, cluster size,
threads a CTA, vector bytes), the CUDA-event ms of the five-call sweep
(two turns), each level's device ms a call by kernel and their sum, the worst error against the plain version relative to each
output's max, and whether the outputs equal the base's bits. The
variants, of the bf16 kernels (``--dtype float32`` times the f32 kernels,
which have none):

- ``cluster2``, ``cluster4``: clusters of at most 2 or 4 CTAs (8 as
  built), so CTAs of more threads (a slab past capacity: two passes);
  ``cluster16``: up to 16 (non-portable), so half the share a CTA at P3;
- ``smem``: the forward's shares held in shared memory filled by TMA bulk
  copies (``kFwdSmem``), not in registers; ``regs``: the backward's held
  in registers (``kBwdSmem``), not in shared memory;
- ``mincta128``: clusters sized for 128 CTAs a call at least (256 as
  built); ``minthreads64``: CTAs of at least 64 threads (128 as built);
- ``maxnreg56``: the forward's threads capped at 56 registers (64 as
  built), so that four CTAs of 288 threads fit an SM;
- ``vec8``: 8-byte vectors (4 bf16) in place of 16-byte ones;
- ``held4``: 4 vectors a thread held of each tensor (8 as built), so
  twice the threads a CTA;
- ``target128``, ``target512``: cluster sizes aimed at CTAs of 128 or 512
  threads (256 as built);
- ``twopass``: the two-pass kernels at every level (the design before the
  cluster kernels);
- ``nofold``, ``nofence`` (backward; timing only, d weight and d bias
  wrong): no arrival counter and no fold of d weight and d bias, or no
  fence between the r writes and the counter.

Device ms are read from a profiled run of 20 sweeps, split by call (each
level's input cold in L2 as in the model, after the previous level).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import threading

import torch

from sipmask_tpu_torch.ops import gn_relu, native
from sipmask_tpu_torch.tools.measure import BATCH, LEVELS, profile_kernels

OUT = native.BUILD_DIR.parent / "k4a_probe"
EDITS = {
    "cluster2": [("constexpr int kMaxCluster = 8;",
                  "constexpr int kMaxCluster = 2;")],
    "cluster4": [("constexpr int kMaxCluster = 8;",
                  "constexpr int kMaxCluster = 4;")],
    "cluster16": [("constexpr int kMaxCluster = 8;",
                   "constexpr int kMaxCluster = 16;"),
                  ("  cfg.numAttrs = 1;\n",
                   "  cfg.numAttrs = 1;\n  cudaFuncSetAttribute(kernel, "
                   "cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n")],
    "smem": [("constexpr bool kFwdSmem = false;",
              "constexpr bool kFwdSmem = true;")],
    "regs": [("constexpr bool kBwdSmem = true;",
              "constexpr bool kBwdSmem = false;")],
    "mincta128": [("constexpr int kMinCtas = 256;",
                   "constexpr int kMinCtas = 128;")],
    "minthreads64": [("constexpr int kMinThreads = 128;",
                      "constexpr int kMinThreads = 64;")],
    "maxnreg56": [("__global__ void __launch_bounds__(kFwdMaxThreads) "
                   "gn_fwd_cluster_kernel(",
                   "__global__ void __maxnreg__(56) gn_fwd_cluster_kernel(")],
    "vec8": [("  if (slab % 8 == 0 && ptrs % 16 == 0) return 8;\n", "")],
    "held4": [("constexpr int kHeld = 8; ", "constexpr int kHeld = 4; ")],
    "target128": [("constexpr int kTarget = 256;",
                   "constexpr int kTarget = 128;")],
    "target512": [("constexpr int kTarget = 256;",
                   "constexpr int kTarget = 512;")],
    "twopass": [("  const bool one = nvec > 0 &&",
                 "  const bool one = false && nvec > 0 &&")],
    "nofold": [("    if (t == 0) last = atomicAdd(arrivals + g, 1u) == "
                "(unsigned)(B - 1);",
                "    if (t == 0) last = 0;")],
    "nofence": [("      __threadfence();\n    }\n  }\n  __syncthreads();",
                 "    }\n  }\n  __syncthreads();")],
}


def log(*args):
    print(*args, flush=True)


def event_ms(fn, iters=20):
    for _ in range(3):
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


def build(name, text, built):
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    built[name] = lib if res.returncode == 0 else res.stderr


def load(path):
    lib = ctypes.CDLL(str(path))
    lib.gn_relu_error_string.argtypes = [ctypes.c_int]
    lib.gn_relu_error_string.restype = ctypes.c_char_p
    ref = gn_relu._lib()   # the argument types of the entries
    for name in ("gn_relu_f32", "gn_relu_bf16", "gn_relu_bwd_f32",
                 "gn_relu_bwd_bf16", "gn_relu_bf16_plan"):
        fn, rf = getattr(lib, name), getattr(ref, name)
        fn.restype, fn.argtypes = rf.restype, rf.argtypes
    return lib


def plan(lib, x, backward):
    """The C entry's plan of a bf16 call on x: (one, K, T, per, vec)."""
    b, c, h, w = x.shape
    out = (ctypes.c_longlong * 5)()
    lib.gn_relu_bf16_plan(c // 32 * h * w, b * 32, c // 32, x.data_ptr(),
                          int(backward), out)
    return tuple(out)


def forward(lib, x, wt, bs):
    """One K4a launch through ``lib``, as ``gn_relu_forward`` makes it,
    with a scratch large enough for the two passes' partials."""
    b, c, h, w = x.shape
    n = b * 32 * 2 * (1 + -(-(c // 32 * h * w) // 4096))
    y = torch.empty_like(x)
    scratch = torch.empty((n,), device=x.device)
    entry = lib.gn_relu_bf16 if x.dtype == torch.bfloat16 else \
        lib.gn_relu_f32
    code = entry(x.data_ptr(), wt.data_ptr(), bs.data_ptr(),
                 scratch.data_ptr(), n, y.data_ptr(), b, c, h * w, 32, 1e-5,
                 1, 1, native.stream_ptr(x.device))
    native.check_launch(lib, "gn_relu", code)
    return y, scratch[: b * 32 * 2].view(b, 32, 2)


def backward(lib, arrivals, x, wt, bs, stats, dy):
    """One K4b launch through ``lib``, as ``gn_relu_backward`` makes it."""
    b, c, h, w = x.shape
    r = torch.empty((b, c, 2), device=x.device)
    dx = torch.empty_like(x)
    dw, db = torch.empty_like(wt), torch.empty_like(bs)
    ptrs = (x.data_ptr(), dy.data_ptr(), stats.data_ptr(), wt.data_ptr(),
            bs.data_ptr(), r.data_ptr(), dx.data_ptr(), dw.data_ptr(),
            db.data_ptr())
    stream = native.stream_ptr(x.device)
    if x.dtype == torch.bfloat16:
        code = lib.gn_relu_bwd_bf16(*ptrs, arrivals.data_ptr(), b, c, h * w,
                                    32, 1, stream)
    else:
        code = lib.gn_relu_bwd_f32(*ptrs, b, c, h * w, 32, 1, stream)
    native.check_launch(lib, "gn_relu", code)
    return dx, dw, db


def worst_error(got, want):
    return max(float((a.float() - e.float()).abs().max())
               / max(float(e.float().abs().max()), 1e-30)
               for a, e in zip(got, want))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help="edited copies to build and time (all if none "
                         "named)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--backward", action="store_true",
                    help="K4b (the backward) in place of K4a")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4a_probe: no CUDA device")
    elem = getattr(torch, args.dtype)
    names = list(EDITS) if args.variants == [] else (args.variants or [])
    if names and elem != torch.bfloat16:
        raise SystemExit("k4a_probe: the variants edit the bf16 kernels")
    text = (native.CSRC_DIR / "gn_relu.cu").read_text()
    built, threads = {}, []
    for name in ["base"] + names:
        edited = text
        for part in name.split("+"):
            for old, new in EDITS.get(part, []):
                if old not in edited:
                    raise ValueError(f"variant {name}: edit not found")
                edited = edited.replace(old, new)
        threads.append(threading.Thread(target=build,
                                        args=(name, edited, built)))
        threads[-1].start()
    for t in threads:
        t.join()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    wt = (torch.rand(256, generator=gen) + 0.5).to(dev)
    bs = (torch.randn(256, generator=gen) * 0.2).to(dev)
    ins = []
    for h, w in LEVELS:
        x = (torch.randn((BATCH, 256, h, w), generator=gen) * 3 + 1).to(
            dev).to(elem)
        dy = torch.randn((BATCH, 256, h, w), generator=gen).to(dev).to(elem)
        _, stats = gn_relu.gn_relu_forward(x, wt, bs, 32)
        ins.append((x, stats, dy))
    if args.backward:
        want = [gn_relu.gn_relu_backward_plain(x, wt, bs, st, dy, 32, True)
                for x, st, dy in ins]
    else:
        want = [gn_relu._forward_plain(x, wt, bs, 32, 1e-5, True)
                for x, _, _ in ins]
    kind = "K4b" if args.backward else "K4a"
    ref = None
    for name in ["base"] + names:
        if not isinstance(built[name], type(OUT)):
            raise RuntimeError(f"nvcc failed on {name}:\n{built[name]}")
        lib = load(built[name])
        arrivals = torch.zeros(64, device=dev, dtype=torch.int32)
        if args.backward:
            calls = [lambda x=x, st=st, dy=dy: backward(lib, arrivals, x, wt,
                                                        bs, st, dy)
                     for x, st, dy in ins]
        else:
            calls = [lambda x=x: forward(lib, x, wt, bs) for x, _, _ in ins]

        def sweep(calls=calls):
            return [fn() for fn in calls]
        out = sweep()
        torch.cuda.synchronize()
        ref = ref or out
        same = all(torch.equal(a, b) for o, r in zip(out, ref)
                   for a, b in zip(o, r))
        again = all(torch.equal(a, b) for o, r in zip(sweep(), out)
                    for a, b in zip(o, r))
        err = max(worst_error(o, e) for o, e in zip(out, want))
        e1, e2 = event_ms(sweep), event_ms(sweep)
        plans = [plan(lib, x, args.backward) if elem == torch.bfloat16
                 else None for x, _, _ in ins]
        per_call = [1 if p and p[0] else 2 for p in plans]
        kern = sorted(profile_kernels(sweep, 20),
                      key=lambda e: e.time_range.start)
        levels, total = [], 0.0
        if len(kern) != 20 * sum(per_call):
            levels.append(f"({len(kern)} kernels are not 20 sweeps of "
                          f"{sum(per_call)}: no split by level)")
        for i, ((h, w), p) in enumerate(zip(LEVELS, plans)):
            parts = {}
            for rep in range(20 if len(kern) == 20 * sum(per_call) else 0):
                at = rep * sum(per_call) + sum(per_call[:i])
                for e in kern[at:at + per_call[i]]:
                    key = e.name.split("(")[0].split("<")[0].split(" ")[-1]
                    parts[key] = parts.get(key, 0.0) + e.device_time / 2e4
            total += sum(parts.values())
            levels.append(
                f"{h}x{w} " + (f"[{'one' if p[0] else 'two'}-pass K={p[1]} "
                               f"T={p[2]} vec {2 * p[4]} B] " if p else "")
                + "; ".join(f"{k} {v:.4f}" for k, v in parts.items()))
        log(f"{kind} {args.dtype} {name}: CUDA events {e1:.4f} / {e2:.4f} ms "
            f"a sweep, device {total:.4f} ms, worst error vs plain "
            f"{err:.3e}, same bits as base {same}, twice {again}")
        for line in levels:
            log(f"  {line}")


if __name__ == "__main__":
    main()
