"""What a run loads holds no module of JAX or of the JAX package, and the
reference loads nothing of the program. Top-level names are compared
whole: ``sipmask_tpu_torch`` is not ``sipmask_tpu``."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import json, sys
from port_bench.tests import tiny
from port_bench.run import forbidden_modules
tiny.run("{cell}", 5)
print(json.dumps(forbidden_modules()))
"""

REFERENCE = """
import json, sys, torch
from port_bench import inputs, flops, spec
from port_bench.reference import decode, loss, model, ops, train
c = spec.load_cell("sipmaskpp.train")
flops.count(c.config, c.traffic, training=True)
w = inputs.make_weights(c.config, 1, "cpu", False)
net = model.build(c.config["model"], "cpu"); net.load_state_dict(w)
net(torch.zeros(1, 3, 64, 64))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules(code):
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600,
                       env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    for cell in ("flagship.train", "sipmaskpp.serve"):
        assert _modules(RUN.format(cell=cell)) == []


def test_the_reference_loads_nothing_of_the_program():
    tops = _modules(REFERENCE)
    assert "sipmask_tpu_torch" not in tops
    assert not {"jax", "jaxlib", "flax", "optax", "sipmask_tpu"} & set(tops)
