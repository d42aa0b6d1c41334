"""One rank of a gloo process group on the CPU for
tests/test_torch_distributed.py: the port's data-parallel train step, its
checkpoints, the sharded ``run_inference`` and the CLIs' distributed flags.

    python tests/_torch_dist_worker.py SPEC.pkl RANK

SPEC.pkl holds {"world", "port", "out", "before", "references", "group",
"after"}: the cases in "before" run with no process group; rank 0 then
runs each case named in "references" on the whole batch, as one process,
and keeps it; the cases in "group" run in one gloo group of "world" ranks
joined at 127.0.0.1:"port", rank 0 holding each against its reference;
those in "after" once that group is gone (the CLIs, which join their
own). Each case is a dict with a "name" and a "kind" (a function below);
its result goes to ``out/<name>.<rank>.pt``: metrics, sha256 digests of
the parameters and momentum (bit equality) and, against a reference, the
largest error of each. The test file imports this module for the same
functions.
"""

import hashlib
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def port_cfg(spec):
    """(preset, [(path, {field: value}), ...]) -> the port's config."""
    from sipmask_tpu_torch.config import _r, get_config
    name, edits = spec
    cfg = get_config(name)
    for path, kw in edits:
        cfg = _r(cfg, path, **kw)
    return cfg


def global_batch(spec):
    """("demo", demo_batch kwargs) or ("vis", vis_pair_batch kwargs) ->
    the global batch as CPU tensors."""
    from sipmask_tpu_torch.utils.demo_inputs import (batch_to_tensors,
                                                     demo_batch,
                                                     vis_pair_batch)
    kind, kw = spec
    if kind == "vis":
        return vis_pair_batch(device="cpu", **kw)
    return batch_to_tensors(demo_batch(**kw))


def shard(batch, rank, world):
    """Rank ``rank``'s rows of the global batch: rows are split in order,
    as the JAX package's process-local feeding splits them."""
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def initial_weights(spec):
    """A case's weights: a state_dict file, or ("bumped", preset spec,
    seed): the port's init with fcos_reg's bias at 2.0, or ("pp", preset
    spec, batch spec): ``_torch_parity.pp_state_dict`` on the batch."""
    if isinstance(spec, str):
        return torch.load(spec, weights_only=False)
    from sipmask_tpu_torch.models.detector import build_model
    kind, cfg_spec, arg = spec
    model = build_model(port_cfg(cfg_spec).model)
    if kind == "pp":
        from _torch_parity import pp_state_dict
        return pp_state_dict(model, global_batch(arg)["images"],
                             training=True)
    from sipmask_tpu_torch.utils.convert import init_weights
    init_weights(model, torch.Generator().manual_seed(arg))
    with torch.no_grad():
        model.bbox_head.fcos_reg.bias.fill_(2.0)
    return model.state_dict()


def snapshot(state):
    """The parameters and momentum buffers of a ``TrainState`` by name."""
    names = {p: n for n, p in state.model.named_parameters()}
    return dict(
        params={n: p.detach().clone()
                for n, p in state.model.named_parameters()},
        momentum={names[p]: s["momentum_buffer"].clone()
                  for p, s in state.optimizer.state.items()})


def digest(tensors):
    """sha256 of the tensors' names, shapes and bytes, in name order."""
    h = hashlib.sha256()
    for n in sorted(tensors):
        t = tensors[n].detach().contiguous()
        h.update(f"{n}{tuple(t.shape)}{t.dtype}".encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def summary(snap):
    return {part: digest(tensors) for part, tensors in snap.items()}


def worst_error(got, want):
    """The largest |got - want| relative to each tensor's max |want|, and
    the tensor's name."""
    if got.keys() != want.keys():
        raise AssertionError(f"names differ: {got.keys() ^ want.keys()}")
    errs = []
    for n, w in want.items():
        scale = float(w.abs().max())
        err = float((got[n] - w).abs().max())
        errs.append((err / scale if scale else err, n))
    return max(errs)


def _state(case):
    from sipmask_tpu_torch.train import create_train_state
    cfg = port_cfg(case["cfg"])
    return cfg, create_train_state(cfg, "cpu",
                                   state_dict=initial_weights(
                                       case["weights"]),
                                   steps_per_epoch=10)


def train(case, rank, world):
    """``case["steps"]`` (1) steps of ``make_train_step`` on this rank's
    shard of the global batch: each step's metrics, the parameters and the
    momentum."""
    from sipmask_tpu_torch.train import make_train_step
    cfg, state = _state(case)
    step = make_train_step(state, cfg)
    batch = shard(global_batch(case["batch"]), rank, world)
    metrics = [{k: v.item() for k, v in step(batch).items()}
               for _ in range(case.get("steps", 1))]
    return dict(metrics=metrics, **snapshot(state))


def losses(case, rank, world):
    """``compute_losses`` of the forward on this rank's shard."""
    from sipmask_tpu_torch.models.loss import compute_losses
    cfg, state = _state(case)
    batch = shard(global_batch(case["batch"]), rank, world)
    head = cfg.model.head
    with torch.no_grad():
        out = state.model(batch["images"],
                          batch["ref_images"] if head.track else None)
        got = compute_losses(out, batch, head, max_pos=cfg.train.max_pos,
                             rescore_fn=state.model.rescore
                             if head.rescoring else None)
    return {k: v.item() for k, v in got.items()}


def checkpoint(case, rank, world):
    """2 steps, ``save_checkpoint``, a fresh state of other weights,
    ``latest_checkpoint`` and ``restore_checkpoint``, 1 more step; an
    unbroken 3-step run from the same weights; and one process's
    checkpoint (``case["single"]``) restored: their losses and digests."""
    from sipmask_tpu_torch.train import create_train_state, make_train_step
    from sipmask_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    cfg, state = _state(case)
    batch = shard(global_batch(case["batch"]), rank, world)
    step = make_train_step(state, cfg)
    for _ in range(2):
        step(batch)
    path = os.path.join(case["work_dir"], "ckpt_step2.pth")
    save_checkpoint(path, state, meta=dict(test=True))
    fresh = create_train_state(cfg, "cpu", seed=1, steps_per_epoch=10)
    latest = latest_checkpoint(case["work_dir"])
    if latest != os.path.abspath(path):
        raise AssertionError(f"latest_checkpoint {latest}")
    restore_checkpoint(latest, fresh)
    if fresh.step != 2:
        raise AssertionError(f"restored at step {fresh.step}")
    resumed = make_train_step(fresh, cfg)(batch)["loss_total"].item()
    _, straight = _state(case)
    step = make_train_step(straight, cfg)
    for _ in range(3):
        unbroken = step(batch)["loss_total"].item()
    # and the other way round: one process's checkpoint on every rank
    other = create_train_state(cfg, "cpu", seed=1, steps_per_epoch=10)
    restore_checkpoint(case["single"], other)
    return dict(path=path, loss_resumed=resumed, loss_straight=unbroken,
                steps=(fresh.step, straight.step),
                resumed=summary(snapshot(fresh)),
                straight=summary(snapshot(straight)),
                from_one_process=(other.step, summary(snapshot(other))))


def evaluate(case, rank, world):
    """``run_inference`` with ``distributed`` (random init from seed 0),
    collected over the process group and through part files."""
    from sipmask_tpu_torch.apis.inference import init_detector
    from sipmask_tpu_torch.apis.test import run_inference
    from sipmask_tpu_torch.data.coco import CocoDataset
    det = init_detector(port_cfg(case["cfg"]), "cpu", seed=0)
    ds = CocoDataset(case["ann"], case["images"], test_mode=True, min_size=1)
    distributed = world > 1
    gather = run_inference(det, ds, batch_size=2, progress=False,
                           distributed=distributed)
    files = run_inference(det, ds, batch_size=2, progress=False,
                          distributed=distributed, tmpdir=case["tmpdir"])
    return dict(gather=gather, tmpdir=files)


def train_cli(case, rank, world):
    """tools/train.py --distributed with an explicit coordinator: the
    state's step and digests."""
    from sipmask_tpu_torch.tools import train as train_cli_mod
    state = train_cli_mod.main(case["argv"] + [
        "--distributed", "--coordinator", f"127.0.0.1:{case['port']}",
        "--num-processes", str(world), "--process-id", str(rank)])
    return dict(step=state.step, **summary(snapshot(state)))


def eval_cli(case, rank, world):
    """tools/test.py --dist with torchrun's environment; what it
    returns (rank 0's stats, None elsewhere)."""
    from sipmask_tpu_torch.tools import test as test_cli_mod
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(case["port"]))
    return dict(stats=test_cli_mod.main(case["argv"] + ["--dist"]))


KINDS = dict(train=train, losses=losses, checkpoint=checkpoint,
             evaluate=evaluate, train_cli=train_cli, eval_cli=eval_cli)


def run(cases, spec, rank, references=None):
    for case in cases:
        out = KINDS[case["kind"]](case, rank, spec["world"])
        if case["kind"] == "train":   # digests, and errors to a reference
            snap = {k: out.pop(k) for k in ("params", "momentum")}
            out.update(summary(snap))
            ref = (references or {}).get(case["name"])
            if ref is not None:
                out["reference_metrics"] = ref["metrics"]
                out["worst"] = {part: worst_error(snap[part], ref[part])
                                for part in snap}
        torch.save(out, os.path.join(spec["out"], f"{case['name']}.{rank}.pt"))


def main():
    import pickle
    from sipmask_tpu_torch.parallel import (destroy_distributed,
                                            init_distributed)
    torch.set_num_threads(1)
    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)
    rank = int(sys.argv[2])
    run(spec.get("before", []), dict(spec, world=1), rank)
    references = {c["name"]: train(c, 0, 1) for c in spec["group"]
                  if rank == 0 and c["name"] in spec.get("references", ())}
    init_distributed(f"127.0.0.1:{spec['port']}", spec["world"], rank,
                     device="cpu")
    try:
        run(spec.get("group", []), spec, rank, references)
    finally:
        destroy_distributed()
    run(spec.get("after", []), spec, rank)
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main()
