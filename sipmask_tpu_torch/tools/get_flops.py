"""Parameters and forward FLOPs of a preset (the JAX package's
``tools/get_flops.py``):

    python -m sipmask_tpu_torch.tools.get_flops sipmask_r50_fpn_gn_1x \\
        --shape 800 1344

Parameters are counted as the JAX tool counts its ``params`` tree: every
learned tensor of the model that its ``__call__`` reaches (frozen BN's
statistics and affine are constants there and buffers here; SipMask++'s
rescoring tower, reached only through ``rescore``, is left out as the JAX
tool's ``init`` leaves it out). FLOPs are
``torch.utils.flop_counter.FlopCounterMode`` over one forward of a batch
of 1 at ``--shape`` on ``--device``, the model routed through the kernels'
custom ops (``ops/custom.py``), whose formulas count K1's and K5's
bilinear taps and K6's products: convolutions, matrix products and those
taps, two FLOPs a multiply-add. XLA's ``cost_analysis``, which the JAX
tool prints, counts elementwise work too (normalisations, activations,
additions) and the convolutions as its compiler rewrote them: on the
flagship at the tests' shrink (FPN and head 32 wide, 128x160) this count
was 1.050 of XLA's (``tests/test_torch_tools.py``).
"""

from __future__ import annotations

import argparse


def count_params(model, cfg) -> int:
    """The parameter count of the JAX tool's ``params`` tree."""
    skip = ("bbox_head.convs_scoring", "bbox_head.mask_scoring") \
        if cfg.model.head.rescoring else ()
    return sum(p.numel() for name, p in model.named_parameters()
               if not name.startswith(skip))


def main(argv=None):
    ap = argparse.ArgumentParser(description="Parameters and FLOPs.")
    ap.add_argument("config", nargs="?", default="sipmask_r50_fpn_gn_1x")
    ap.add_argument("--shape", type=int, nargs=2, default=[544, 544])
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from ..apis.inference import init_detector
    from ..config import apply_overrides, get_config
    from ..ops.custom import route_through_ops
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    det = init_detector(cfg, args.device)
    h, w = args.shape
    n_params = count_params(det.model, cfg)
    x = torch.zeros((1, 3, h, w), device=args.device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), route_through_ops(), counter:
        det.model(x)
    flops = counter.get_total_flops()
    print(f"config: {cfg.name}  input: {h}x{w}")
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"forward flops: {flops / 1e9:.2f} GFLOPs")
    return n_params, flops


if __name__ == "__main__":
    main()
