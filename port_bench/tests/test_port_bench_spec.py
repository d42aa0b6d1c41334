"""The harness finds every cell, configuration, traffic mix, limit and
metric of ``BENCHMARK.json`` by name, and a cell defined only in new
files."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(name):
    c = spec.load_cell(name)
    assert c.chips in (1, 4)
    assert spec.kind(c.traffic).run
    assert {"setup_s"} < {m["name"] for m in c.end_to_end}
    for m in c.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        # every per-layer metric moves an end-to-end metric of the cell
        assert m["moves"] in {e["name"] for e in c.end_to_end}
    assert c.limits["checks"]


def test_every_config_file_is_the_preset():
    from port_bench import program
    for c in BENCH["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"] == []
        program.preset(conf)          # raises on any number that differs


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m


def test_a_cell_made_only_of_new_files(tmp_path):
    """A configuration, a traffic mix of a known kind, limits and a metric
    added as files, and entries in BENCHMARK.json, resolve with no edit of
    a file that is there."""
    pkg = tmp_path / "port_bench"
    shutil.copytree(ROOT / "port_bench", pkg,
                    ignore=shutil.ignore_patterns("__pycache__"))
    conf = json.loads((ROOT / BENCH["configs"][0]["file"]).read_text())
    (pkg / "configs" / "throwaway.json").write_text(json.dumps(conf))
    traffic = json.loads(
        (pkg / "traffic" / "coco_train_b4_800x1344.json").read_text())
    (pkg / "traffic" / "throwaway_mix.json").write_text(
        json.dumps(dict(traffic, batch=2)))
    (pkg / "limits" / "throwaway.cell.json").write_text(
        json.dumps({"checks": {"loss_gap": 1.0}}))
    (pkg / "metrics" / "throwaway.metric.py").write_text(
        "def read(t):\n    return 42.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][0], name="throwaway",
                                 file="port_bench/configs/throwaway.json"))
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "throwaway",
                               "traffic": "throwaway_mix", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "%",
                               "better": "higher", "source": "device_trace",
                               "layer": "model", "moves": "train_img_s",
                               "workloads": ["throwaway.cell"]})
    for m in bench["end_to_end"]:
        if m["name"] == "train_img_s":
            m["workloads"].append("throwaway.cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.load_cell("throwaway.cell", tmp_path / "BENCHMARK.json")
    assert c.traffic["batch"] == 2 and c.pkg == pkg
    assert c.config["preset"] == conf["preset"]
    assert [m["name"] for m in c.per_layer][-1] == "throwaway.metric"
    assert spec.metric_reader("throwaway.metric", c.pkg)(None) == 42.0
    assert spec.kind(c.traffic).__name__ == "port_bench.kinds.train_pool"


def test_run_refuses_without_the_chips():
    """Without CUDA the command prints no result and exits non-zero."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "flagship.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
