"""The system under test, ``sipmask_tpu_torch``: the only module of the
benchmark that imports it. The benchmark takes from it the entry points a
user calls (the preset, the train state and step, the detector and its
preprocessing, the precision setting) and nothing of its arithmetic."""

from __future__ import annotations

import dataclasses


def preset(config: dict):
    """The program's preset named by a configuration file, with the
    file's compute dtype (and the file's ``overrides``, dotted
    ``key=value`` strings, which the tests use to shrink a preset).
    Raises where a number of the file's ``model``, ``data`` or ``train``
    differs from the preset's: the file is what the reference runs."""
    from sipmask_tpu_torch.config import _r, apply_overrides, get_config

    cfg = apply_overrides(get_config(config["preset"]),
                          config.get("overrides", []))
    cfg = _r(cfg, "model", compute_dtype=config["compute_dtype"])
    _agree(dataclasses.asdict(cfg), {k: config[k] for k in
                                     ("model", "data", "train")}, "")
    return cfg


def _agree(ours, theirs, path):
    if isinstance(theirs, dict):
        for k, v in theirs.items():
            if k not in ours:
                raise KeyError(f"the preset has no {path}{k}")
            _agree(ours[k], v, f"{path}{k}.")
        return
    a = list(ours) if isinstance(ours, (list, tuple)) else ours
    b = list(theirs) if isinstance(theirs, (list, tuple)) else theirs
    if _norm(a) != _norm(b):
        raise ValueError(f"{path[:-1]}: the preset has {ours!r}, the "
                         f"configuration file {theirs!r}")


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, bool) or v is None or isinstance(v, str):
        return v
    return float(v)


def load():
    """Import the program's entry points (set-up notes its seconds)."""
    import sipmask_tpu_torch.apis.inference  # noqa: F401
    import sipmask_tpu_torch.train  # noqa: F401


def no_tf32():
    from sipmask_tpu_torch.utils.precision import no_tf32 as off
    off()


def train_state(cfg, device, weights):
    """``create_train_state`` with the benchmark's weights, and the step
    that ``make_train_step`` makes of it."""
    from sipmask_tpu_torch.train import create_train_state, make_train_step

    state = create_train_state(cfg, device, state_dict=weights)
    return state, make_train_step(state, cfg)


def detector(cfg, device, weights):
    """A ``Detector`` in eval mode with the benchmark's weights."""
    from sipmask_tpu_torch.apis.inference import Detector
    from sipmask_tpu_torch.models.detector import build_model

    model = build_model(cfg.model)
    model.load_state_dict(weights)
    return Detector(cfg, model.to(device).eval(), device)


def preprocess(img, cfg):
    """The program's test-time transform of one BGR uint8 image."""
    from sipmask_tpu_torch.apis.inference import preprocess as prep
    return prep(img, cfg)
