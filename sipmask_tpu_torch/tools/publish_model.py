"""Prepare a checkpoint for release (the JAX package's
``tools/publish_model.py``): keep the weights of a checkpoint that
``utils/checkpoint.py`` wrote (no optimizer state, no step), stamp the
file name with the first 8 hex digits of a SHA-256 over the sorted
``state_dict`` names and bytes, and write ``meta.json`` beside it:

    python -m sipmask_tpu_torch.tools.publish_model WORK_DIR/epoch_12.pth \\
        release/sipmask_r50

writes ``release/sipmask_r50-<hash8>/model.pth`` and ``meta.json`` (the
checkpoint's meta with ``sha256_8``). The file loads with
``utils.checkpoint.load_weights``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil


def digest(state_dict) -> str:
    """SHA-256 over the names and the bytes of ``state_dict``'s tensors,
    in name order."""
    h = hashlib.sha256()
    for k in sorted(state_dict):
        h.update(k.encode())
        h.update(state_dict[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    ap = argparse.ArgumentParser(description="Publish a checkpoint.")
    ap.add_argument("in_ckpt", help="a checkpoint file of the port")
    ap.add_argument("out_ckpt", help="output directory; -{hash8} is "
                                     "appended")
    args = ap.parse_args(argv)

    import torch
    from ..utils.precision import no_tf32

    no_tf32()
    ckpt = torch.load(args.in_ckpt, map_location="cpu", weights_only=False)
    sd = {k: v for k, v in ckpt.get("state_dict", ckpt).items()
          if not k.endswith("num_batches_tracked")}
    sha8 = digest(sd)[:8]
    out = os.path.abspath(f"{args.out_ckpt.rstrip('/')}-{sha8}")
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    torch.save({"state_dict": sd}, os.path.join(out, "model.pth"))
    meta = dict(ckpt.get("meta", {})) if "state_dict" in ckpt else {}
    meta["sha256_8"] = sha8
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    n_params = sum(v.numel() for v in sd.values()
                   if v.is_floating_point())
    print(f"published {out} ({n_params / 1e6:.2f} M params)")
    return out


if __name__ == "__main__":
    main()
