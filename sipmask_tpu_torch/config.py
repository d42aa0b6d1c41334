"""The model presets, shared with the JAX package without importing it.

``sipmask_tpu/config.py`` holds only dataclasses and the preset registry, so
the port executes that one file as its own module and never imports the
``sipmask_tpu`` package (whose other modules need JAX). Config objects made by
either package work in both: the port only reads their fields.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_SRC = Path(__file__).resolve().parents[1] / "sipmask_tpu" / "config.py"
_spec = importlib.util.spec_from_file_location(__name__ + "_presets", _SRC)
_presets = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = _presets   # dataclasses look their module up
_spec.loader.exec_module(_presets)

SipMaskConfig = _presets.SipMaskConfig
get_config = _presets.get_config
list_configs = _presets.list_configs
_r = _presets._r
