"""Spans: named stretches of the port's host work on the profiler's clock.

``span(name)`` opens a host-only range of ``torch.profiler``
(``torch._C._profiler._RecordFunctionFast``): a CPU operation on Kineto's
clock, the clock of the device's events, so that a trace can put each
device operation (by the host call that enqueued it) and each idle gap of
the device down to the stage that held the host. Spans nest on a thread.
Unlike ``torch.profiler.record_function`` a span is no user annotation, so
PyTorch does not project it onto the device timeline as a
``gpu_user_annotation`` event: it adds no event of device type CUDA, and
traces count the same device operations with and without it.

Tracing is on exactly while a ``torch.profiler`` session runs; with none
running a span costs its call (about a third of a microsecond). Every name
starts with ``sipmask.``:

- ``sipmask.step.forward``, ``.loss``, ``.backward``, ``.update``: the
  stages of ``train/step.py``'s step;
- ``sipmask.infer.forward``, ``.decode``: ``Detector.infer``;
- ``sipmask.K1`` ... ``sipmask.K6``: the whole call of each kernel's
  public wrapper in ``ops/`` (:func:`spanned`), on every route it takes;
- ``sipmask.test.paste``, ``.encode`` and ``sipmask.video.model``,
  ``.track``, ``.paste``: the test drivers' sections, which also time
  themselves into a caller's ``timings`` dict.
"""

from __future__ import annotations

import functools
import time

import torch
from torch._C._profiler import _RecordFunctionFast


class _Timed:
    """A span that appends its host ms to ``timings[<last part of the
    name>]``, after a synchronise of ``device`` (a ``torch.device``) when it
    is a CUDA device."""

    def __init__(self, name: str, timings: dict, device):
        self._range = _RecordFunctionFast(name)
        self._key = name.rsplit(".", 1)[-1]
        self._timings, self._device = timings, device

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        self._timings.setdefault(self._key, []).append(
            (time.perf_counter() - self._t0) * 1e3)
        return self._range.__exit__(*exc)


def span(name: str, timings: dict = None, device=None):
    """A context manager: the host-only profiler range ``name``. With a
    ``timings`` dict it also appends the section's host ms to
    ``timings[<last part of name>]``, ended by a synchronise of ``device``
    (a ``torch.device``) when that is a CUDA device."""
    if timings is None:
        return _RecordFunctionFast(name)
    return _Timed(name, timings, device)


def spanned(name: str):
    """Decorate a function so that each whole call is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _RecordFunctionFast(name):
                return fn(*args, **kwargs)
        return call
    return wrap
