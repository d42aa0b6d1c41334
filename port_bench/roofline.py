"""The least time the card could take for the program's kernels K1-K6, from
the shapes of their calls (``flops.count``'s record).

Each call's least time is the larger of its bytes over the HBM rate (each
input read once, each output written once) and its operations over the
compute rate that does them (f32 on the CUDA cores; K2's two products as
three TF32 products each on the tensor cores, as it computes them). K3's
and K6's operations depend on the boxes (the pixels inside them), so
they are left out and their bytes bound them: a lower bound, which keeps
a share made from it at or below the true one. Peaks are NVIDIA's for
the H100 SXM at 700 W.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
PEAK_FLOP_PER_S = {"float32": F32_FLOP_PER_S, "bfloat16": BF16_FLOP_PER_S}


def bound(nbytes, flops=0.0, tc_flops=0.0, tc_rate=TF32_FLOP_PER_S):
    """Seconds: moving ``nbytes`` at the HBM rate, or ``flops`` on the CUDA
    cores and ``tc_flops`` on the tensor cores side by side."""
    return max(nbytes / HBM_BYTES_PER_S,
               flops / F32_FLOP_PER_S, tc_flops / tc_rate)


def least(calls, training: bool):
    """{kernel id: least seconds} of one step or batch whose forward made
    ``calls``; in training each forward kernel's backward one too."""
    out = {}

    def add(k, s):
        out[k] = out.get(k, 0.0) + s

    for name, sh in calls:
        if name in ("im2col", "rows"):
            b, c, h, w = sh["x"]
            _, o, ho, wo = sh["out"]
            p = ho * wo
            offs = math.prod(sh["offsets"])
            cols = b * 9 * c * p
            if name == "im2col":
                add("K1", bound(4 * (b * c * h * w + offs + cols), 7 * cols))
                if training:
                    w2 = o * 9 * c
                    add("K2", bound(8 * (b * c * h * w + offs + w2)
                                    + 4 * (b * o * p + cols), 16 * cols,
                                    3 * 4 * cols * o))
            else:
                pyx = b * 9 * p * 2
                add("K5", bound(4 * (b * c * h * w + pyx + cols), 7 * cols))
                if training:
                    add("K5c", bound(8 * (b * c * h * w + pyx) + 4 * cols,
                                     18 * cols))
        elif name == "gn":
            n, c = math.prod(sh["x"]), sh["x"][1]
            add("K4a", bound(8 * n + 8 * c, 8 * n))
            if training:
                add("K4b", bound(12 * n, 10 * n))
        elif name == "mask_bce":
            b, nb, h, w = sh["basis"]
            k = sh["cofs"][1]
            basis, cofs, gt = 4 * b * nb * h * w, 4 * b * k * 4 * nb, \
                math.prod(sh["gt"])
            rest = gt + b * k * (16 + 8 + 1)     # boxes, gt index, valid
            add("K3a", bound(basis + cofs + rest + 4 * b * k))
            if training:
                add("K3b", bound(2 * (basis + cofs) + rest + 4 * b * k))
        elif name == "assemble":
            b, h, w, nb = sh["basis"]
            n = sh["cofs"][1]
            add("K6", bound(4 * (b * h * w * nb + b * n * (4 * nb + 4))
                            + 4 * b * n * h * w))
    return out
