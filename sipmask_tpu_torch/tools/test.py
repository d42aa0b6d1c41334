"""Evaluate a SipMask preset with the port (COCO bbox and segm):

    python -m sipmask_tpu_torch.tools.test sipmask_r50_fpn_gn_1x \\
        WORK_DIR/epoch_1.pth --ann ANN.json --img-prefix IMAGES

Sharded over N GPUs, one process each, the results collected over the
process group (or through part files in ``--tmpdir``, a directory every
process can read), rank 0 reporting:

    torchrun --nproc_per_node N -m sipmask_tpu_torch.tools.test \\
        sipmask_r50_fpn_gn_1x WORK_DIR/epoch_1.pth --dist --ann ANN.json ...

The arguments of the JAX package's ``tools/test.py``, with ``--device``
(``cuda`` by default) and ``--backend`` (default: ``nccl`` on CUDA,
``gloo`` on the CPU). Without a checkpoint the model keeps its random
init.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate a SipMask preset.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--out", default=None, help="write the results json")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--eval", nargs="+", default=["bbox", "segm"])
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist", action="store_true",
                    help="one process of a group that shards the set "
                         "(torchrun's environment); rank 0 reports")
    ap.add_argument("--tmpdir", default=None,
                    help="with --dist: collect through part files here "
                         "instead of over the process group")
    ap.add_argument("--backend", default=None,
                    help="process group backend (default: nccl on cuda, "
                         "gloo on cpu)")
    args = ap.parse_args(argv)

    from ..apis.inference import init_detector
    from ..apis.test import evaluate_coco, results_to_json, run_inference
    from ..config import apply_overrides, get_config
    from ..data.coco import CocoDataset
    from ..parallel import (destroy_distributed, init_distributed,
                            process_shard_args)
    from ..utils.checkpoint import load_weights
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    device = args.device
    if args.dist:
        device = init_distributed(backend=args.backend, device=device)
    try:
        det = init_detector(cfg, device)
        if args.checkpoint:
            load_weights(args.checkpoint, det.model)
        dataset = CocoDataset(args.ann, args.img_prefix, test_mode=True)
        results = run_inference(det, dataset, batch_size=args.batch_size,
                                distributed=args.dist, tmpdir=args.tmpdir)
        if process_shard_args()[0] != 0:
            return None   # every rank holds the results; rank 0 reports
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results_to_json(results), f)
        return evaluate_coco(results, args.ann, metrics=args.eval)
    finally:
        if args.dist:
            destroy_distributed()


if __name__ == "__main__":
    main()
