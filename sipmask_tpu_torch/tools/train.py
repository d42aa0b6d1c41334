"""Train a SipMask preset with the port:

    python -m sipmask_tpu_torch.tools.train sipmask_r50_fpn_gn_1x \\
        --ann ANN.json --img-prefix IMAGES --work-dir WORK_DIR --max-steps 4

A VIS preset (``sipmask_vis_r50``, ``sipmask_vis_r50_ms``) takes a
YouTube-VIS-format ``--ann`` and, with ``--val-ann``, evaluates by
tracking its videos.

Data-parallel over N GPUs, one process each (``imgs_per_device`` images a
process, so the global batch is N times that):

    torchrun --nproc_per_node N -m sipmask_tpu_torch.tools.train \\
        sipmask_r50_fpn_gn_1x --distributed --ann ANN.json ...

``--distributed`` reads the group from torchrun's environment, or from
``--coordinator HOST:PORT --num-processes N --process-id I`` given to each
process; the backend is ``nccl`` on CUDA and ``gloo`` on the CPU. The
arguments of the JAX package's ``tools/train.py``, with ``--device``
(``cuda`` by default).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a SipMask preset.")
    ap.add_argument("config", help="preset name (sipmask_tpu_torch.config)")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--work-dir", required=True)
    ap.add_argument("--load-from", default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--val-ann", default=None,
                    help="evaluate on this val json after each epoch")
    ap.add_argument("--val-img-prefix", default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides, e.g. train.optim.lr=0.005")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--distributed", action="store_true",
                    help="one process of a data-parallel group (torchrun's "
                         "environment, or the three arguments below)")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0, for a launch without torchrun")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args(argv)

    from ..apis.train import (make_coco_eval_hook, make_ytvos_eval_hook,
                              train_detector)
    from ..config import _r, apply_overrides, get_config
    from ..parallel import destroy_distributed, init_distributed
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if args.seed is not None:
        cfg = _r(cfg, "train", seed=args.seed)
    device = args.device
    if args.distributed:
        device = init_distributed(args.coordinator, args.num_processes,
                                  args.process_id, device=device)
    try:
        eval_hook = None
        if args.val_ann:
            make_hook = (make_ytvos_eval_hook if cfg.model.head.track
                         else make_coco_eval_hook)
            eval_hook = make_hook(cfg, args.val_ann,
                                  args.val_img_prefix or args.img_prefix)
        return train_detector(cfg, args.ann, args.img_prefix, args.work_dir,
                              resume=not args.no_resume,
                              load_from=args.load_from,
                              max_steps=args.max_steps, eval_hook=eval_hook,
                              device=device)
    finally:
        if args.distributed:
            destroy_distributed()


if __name__ == "__main__":
    main()
