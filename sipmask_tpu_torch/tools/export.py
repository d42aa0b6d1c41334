"""Export the inference graph with ``torch.export`` and check its round
trip (the JAX package's ``tools/export.py``, which exports StableHLO):

    python -m sipmask_tpu_torch.tools.export sipmask_r50_fpn_ssd_6x \\
        --shape 544 544 --out sipmask_export --check

writes ``sipmask_export/sipmask.pt2`` (``torch.export.save``) and the
weights (``weights.pth``); ``--check`` loads the program with
``torch.export.load``, runs it on the sample and prints the largest
|difference| from the live graph for each output. The kernels enter the
program as the custom ops of ``ops/custom.py`` (K1, K4a, K5, K6), so the
loaded program launches them on the card.

Presets with fast NMS (``sipmask_r50_fpn_ssd_6x`` and the other
real-time ones) export the forward and the decode, as the JAX tool does.
The hard and soft NMS decodes read the device to choose each wave's
survivors, which a traced program cannot, so there the program holds the
forward and ``run_exported`` runs the port's decode after it. The JAX
tool's arguments and ``--device`` (``cuda`` by default).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def exports_decode(cfg) -> bool:
    """True where the exported program holds the decode (fast NMS)."""
    return bool(cfg.model.test.use_fast_nms or cfg.model.head.ssd_flag)


class InferenceGraph(torch.nn.Module):
    """The served graph: the model's forward, and with ``decode`` the
    port's ``decode_batch`` on it."""

    def __init__(self, model, cfg, decode: bool):
        super().__init__()
        self.model, self.cfg, self.decode = model, cfg, decode

    def forward(self, images, img_shapes, scale_factors):
        from ..models.decode import decode_batch
        out = self.model(images)
        if not self.decode:
            return out
        rescore = self.model.rescore if self.cfg.model.head.rescoring \
            else None
        return decode_batch(out, img_shapes, scale_factors, self.cfg.model,
                            rescore_fn=rescore)


def decode_after(cfg, model, out, img_shapes, scale_factors):
    """The port's decode on a forward's outputs (the programs without
    it)."""
    from ..models.decode import decode_batch
    rescore = model.rescore if cfg.model.head.rescoring else None
    with torch.no_grad():
        return decode_batch(out, img_shapes, scale_factors, cfg.model,
                            rescore_fn=rescore)


def export_inference(cfg, checkpoint=None, shape=(544, 544), batch=1,
                     device="cuda"):
    """Trace the inference graph of ``cfg`` with ``torch.export``.

    Returns (exported, infer_fn, sample_args): the ``ExportedProgram``,
    the live function it was traced from (forward and decode, whatever
    the program holds), and the sample arguments (images from
    ``RandomState(0).randn(b, h, w, 3) * 20`` as the JAX tool makes them,
    in NCHW, the shapes (h, w), unit scale factors), so that callers can
    run the saved and loaded program against the live graph."""
    from ..apis.inference import init_detector
    from ..config import get_config
    from ..utils.checkpoint import load_weights
    from ..ops.custom import route_through_ops
    cfg = get_config(cfg) if isinstance(cfg, str) else cfg
    det = init_detector(cfg, device)
    if checkpoint:
        load_weights(checkpoint, det.model)
    h, w = shape
    rng = np.random.RandomState(0)
    images = torch.from_numpy(
        rng.randn(batch, h, w, 3).astype("float32") * 20).permute(
        0, 3, 1, 2).contiguous().to(device)
    img_shapes = torch.tensor([[float(h), float(w)]]).repeat(batch, 1)
    scale_factors = torch.ones((batch, 4), dtype=torch.float32)
    graph = InferenceGraph(det.model, cfg, exports_decode(cfg)).eval()
    args = (images, img_shapes.to(device), scale_factors.to(device))
    with torch.no_grad(), route_through_ops():
        exported = torch.export.export(graph, args)

    @torch.no_grad()
    def infer(images, img_shapes, scale_factors):
        out = graph(images, img_shapes, scale_factors)
        if graph.decode:
            return out
        return decode_after(cfg, det.model, out, img_shapes, scale_factors)
    infer.model = det.model
    infer.cfg = cfg
    return exported, infer, args


def run_exported(exported, cfg, model, *args):
    """Run an exported (or loaded) program on ``args``, then the port's
    decode when the program holds only the forward."""
    with torch.no_grad():
        out = exported.module()(*args)
    if exports_decode(cfg):
        return out
    return decode_after(cfg, model, out, *args[1:])


def max_diffs(got, want):
    """{output: max |got - want|} over the decoded outputs (float)."""
    return {k: float((got[k].float() - want[k].float()).abs().max())
            if got[k].numel() else 0.0 for k in want}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Export the inference graph.")
    ap.add_argument("config", nargs="?", default="sipmask_r50_fpn_ssd_6x")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--shape", type=int, nargs=2, default=[544, 544])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--out", default="sipmask_export")
    ap.add_argument("--check", action="store_true",
                    help="load the saved program, run it and compare it "
                         "with the live graph")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..config import apply_overrides, get_config
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    exported, infer, sample = export_inference(
        cfg, checkpoint=args.checkpoint, shape=tuple(args.shape),
        batch=args.batch, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "sipmask.pt2")
    torch.export.save(exported, path)
    torch.save(infer.model.state_dict(), os.path.join(args.out,
                                                      "weights.pth"))
    print(f"wrote {path} ({os.path.getsize(path)} bytes); the program "
          f"holds the forward{' and the decode' if exports_decode(cfg) else ''}")
    reloaded = torch.export.load(path)
    print("export inputs:", [tuple(a.shape) for a in sample])
    diffs = None
    if args.check:
        got = run_exported(reloaded, cfg, infer.model, *sample)
        diffs = max_diffs(got, infer(*sample))
        print("roundtrip max|diff|:", diffs)
    return reloaded, diffs


if __name__ == "__main__":
    main()
