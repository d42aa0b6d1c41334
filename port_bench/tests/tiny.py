"""Cells of the benchmark shrunk to run on the CPU in seconds: the
published widths and depths, small images, batch 2, a pool of 4."""

from __future__ import annotations

import copy
import time

import torch

from port_bench import harness, spec

SIZE = 256   # SipMask++'s rescoring needs masks of 127 pixels or more


def cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    c.config = copy.deepcopy(c.config)
    c.traffic = dict(c.traffic, batch=2, warm=1, trace=2, size=[SIZE, SIZE])
    if c.traffic["kind"] == "serve_closed":
        c.traffic["original_sizes"] = [[192, 256], [256, 192]]
        c.config["data"]["fixed_size"] = [SIZE, SIZE]
        c.config["overrides"] = [f"data.fixed_size=({SIZE},{SIZE})"]
    return c


def run(name: str, seed: int = 20240101, **kw):
    """(result, notes) of one run of the shrunk cell on the CPU. Serving
    gets a pool of one batch, so that the short window serves the batch
    the check samples."""
    c = cell(name)
    pool = 1 if c.traffic["kind"] == "serve_closed" else 4
    r = harness.Run(c, seed, kw.pop("seconds", 0.5), False,
                    torch.device("cpu"), time.perf_counter(), pool=pool, **kw)
    return spec.kind(c.traffic).run(r)
