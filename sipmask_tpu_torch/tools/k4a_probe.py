"""K4a, the GroupNorm+ReLU forward (``csrc/gn_relu.cu``), and edited copies
of it, on one CUDA card:

    python -m sipmask_tpu_torch.tools.k4a_probe [--variants [NAME ...]]

Inputs are ``tools/measure.py k4a``'s: one GN site of each of the flagship's
five FPN levels at batch 4 (800x1344), 256 channels, 32 groups, with
statistics kept. Builds edited copies of the source into
``build/k4a_probe/`` (all, or the named ones), then prints the card's name
and power limit and, for the source as built (``base``) and each copy, the
CUDA-event ms of the five-call sweep (two turns), its device time (the
kernels' durations in a ``torch.profiler`` trace, summed) and that time by
level, and whether y and the statistics equal the base's bits:

- ``stats16k``: the first pass on chunks of 16384 elements, 16 vectors in
  flight a thread (4096 as built, both passes);
- ``ldcs``: the second pass loads x as streaming (evict-first) data;
- ``stcs``: the second pass stores y as streaming data;
- ``forward``: the second pass walks the slabs in the first pass's order.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import threading

import torch

from sipmask_tpu_torch.ops import gn_relu, native
from sipmask_tpu_torch.tools.measure import (BATCH, LEVELS, by_call,
                                             profile_kernels)

OUT = native.BUILD_DIR.parent / "k4a_probe"
EDITS = {
    "stats16k": [
        ("constexpr int kChunk = kThreads * 16;  // elements of a slab per "
         "block\n",
         "constexpr int kChunk = kThreads * 16;  // elements of a slab per "
         "block\nconstexpr int kStatsChunk = kThreads * 64;\n"),
        ("""  const int64_t lo = (int64_t)blockIdx.x * kChunk;
  const int64_t hi = lo + kChunk < slab ? lo + kChunk : slab;
  VecT<VEC> v[kLoads<VEC>];
  load_chunk<VEC>(reinterpret_cast<const VecT<VEC>*>(x + bg * slab),
                  lo / VEC + threadIdx.x, hi / VEC, v);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i) {""",
         """  const int64_t lo = (int64_t)blockIdx.x * kStatsChunk;
  const int64_t hi = lo + kStatsChunk < slab ? lo + kStatsChunk : slab;
  constexpr int kN = kStatsChunk / kThreads / VEC;
  VecT<VEC> v[kN];
  load_chunk<VEC>(reinterpret_cast<const VecT<VEC>*>(x + bg * slab),
                  lo / VEC + threadIdx.x, hi / VEC, v);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < kN; ++i) {"""),
        ("""  const int S = (int)((slab + kChunk - 1) / kChunk);""",
         """  const int S = (int)((slab + kStatsChunk - 1) / kStatsChunk);"""),
        ("""  const dim3 grid(S, B * G);""",
         """  const dim3 grid(S, B * G);
  const dim3 grid2((unsigned)((slab + kChunk - 1) / kChunk), B * G);"""),
        ("gn_apply_kernel<4><<<grid,", "gn_apply_kernel<4><<<grid2,"),
        ("gn_apply_kernel<1><<<grid,", "gn_apply_kernel<1><<<grid2,"),
        ("""  const int s = S - 1 - (int)blockIdx.x;""",
         """  const int s = gridDim.x - 1 - (int)blockIdx.x;"""),
    ],
    "ldcs": [("""  load_chunk<VEC>(reinterpret_cast<const VecT<VEC>*>(x + bg * slab), e0,
                  e_end, v);""",
              """#pragma unroll
  for (int i = 0; i < kLoads<VEC>; ++i)
    v[i] = e0 + i * kThreads < e_end
               ? __ldcs(reinterpret_cast<const VecT<VEC>*>(x + bg * slab) +
                        e0 + i * kThreads)
               : VecT<VEC>{};""")],
    "stcs": [("      ys[e] = make_float4(o[0], o[1], o[2], o[3]);",
              "      __stcs(ys + e, make_float4(o[0], o[1], o[2], o[3]));")],
    "forward": [("""  const int64_t bg = gridDim.y - 1 - blockIdx.y;
  const int s = S - 1 - (int)blockIdx.x;""",
                 """  const int64_t bg = blockIdx.y;
  const int s = (int)blockIdx.x;""")],
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
    native_lib = gn_relu._lib()   # the argument types of gn_relu_f32
    lib.gn_relu_f32.restype = ctypes.c_int
    lib.gn_relu_f32.argtypes = native_lib.gn_relu_f32.argtypes
    return lib


def call(lib, x, wt, bs):
    """One K4a launch through ``lib``, as ``gn_relu_forward`` makes it,
    with a scratch large enough for any variant's partials."""
    b, c, h, w = x.shape
    n = b * 32 * 2 * (1 + -(-(c // 32 * h * w) // 4096))
    y = torch.empty_like(x)
    scratch = torch.empty((n,), device=x.device)
    code = lib.gn_relu_f32(x.data_ptr(), wt.data_ptr(), bs.data_ptr(),
                           scratch.data_ptr(), n, y.data_ptr(), b, c, h * w,
                           32, 1e-5, 1, 1, native.stream_ptr(x.device))
    native.check_launch(lib, "gn_relu", code)
    return y, scratch[: b * 32 * 2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="*", default=None,
                    help="edited copies to build and time (all if none "
                         "named)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k4a_probe: no CUDA device")
    names = list(EDITS) if args.variants == [] else (args.variants or [])
    text = (native.CSRC_DIR / "gn_relu.cu").read_text()
    built, threads = {}, []
    for name in ["base"] + names:
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
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn((BATCH, 256, h, w), generator=gen).to(dev)
          for h, w in LEVELS]
    wt = torch.ones(256, device=dev)
    bs = torch.zeros(256, device=dev)
    ref = None
    for name in ["base"] + names:
        if not isinstance(built[name], type(OUT)):
            raise RuntimeError(f"nvcc failed on {name}:\n{built[name]}")
        lib = load(built[name])

        def sweep(lib=lib):
            return [call(lib, x, wt, bs) for x in xs]
        out = sweep()
        ref = ref or out
        same = all(torch.equal(a, b) for o, r in zip(out, ref)
                   for a, b in zip(o, r))
        e1, e2 = event_ms(sweep), event_ms(sweep)
        kern = profile_kernels(sweep, 20)
        device = sum(e.device_time for e in kern) / 1e3 / 20
        log(f"K4a {name}: CUDA events {e1:.4f} / {e2:.4f} ms a sweep, "
            f"device {device:.4f} ms, same bits as base {same}")
        by_call(kern, 20, [f"{h}x{w}" for h, w in LEVELS])


if __name__ == "__main__":
    main()
