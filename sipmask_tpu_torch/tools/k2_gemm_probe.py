"""Where K2's GEMM time goes, on one CUDA card:

    python -m sipmask_tpu_torch.tools.k2_gemm_probe

from the root of the checkout. Builds edited copies of
``csrc/deform_col2im.cu`` into ``build/k2_probe/`` and times the two GEMMs
of one K2 call at the FeatureAlign P3 level of an 800x1344 image, batch 4
(``torch.profiler`` device time, mean of 5 calls):

- ``base``: the source as it is;
- ``one_mma``: only the big·big product of 3xTF32 (a third of the tensor
  work, the same loads, splits and flushes): how far the tensor cores bound
  the GEMMs;
- ``chain``: every product into one accumulator, no per-stage
  round-to-nearest flush: what the flush costs;
- ``stages4``: a ring of 4 stages instead of 3.

Only ``base`` computes K2; the others are for timing. The first line is the
card's name and power limit.
"""

from __future__ import annotations

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


def build(name, text, built):
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    cu.write_text(text)
    res = subprocess.run([native.find_nvcc(), *native.NVCC_FLAGS, "-I",
                          str(native.CSRC_DIR), "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr}")
    built[name] = so


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
    lib.deform_conv_bwd_partial_floats.restype = ctypes.c_longlong
    lib.deform_conv_bwd_partial_floats.argtypes = [ctypes.c_int] * 4
    fn = lib.deform_conv_bwd_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p]
    parts = lib.deform_conv_bwd_partial_floats(B, O, kc, p)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("k2_gemm_probe: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip(),
          flush=True)
    src = (native.CSRC_DIR / "deform_col2im.cu").read_text()
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
