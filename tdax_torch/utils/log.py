"""Structured JSONL event log (port of ``tdax/utils/log.py``), and the
port's profiler spans.

Set ``TDAX_LOG=path.jsonl`` (or call ``configure``) to append one JSON
object per event: ``{"ts", "event", **fields}``.  Nothing is written
when neither is set.

``span(name)`` marks a stretch of the port's host code as a
``tdax.<name>`` range on torch.profiler's timeline, the clock of the
device trace, whenever a profiler records: wrap a run in
``torch.profiler.profile`` to see them.  The profiler records the thread
that started it and the threads it hands its state to (autograd's); a
range on another thread, such as the extract loop's image thread, shows
when it records every thread
(``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``).  With no profiler a span is one shared
no-op context.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch
from torch.autograd import profiler as _profiler

_path: str | None = None
_OFF = contextlib.nullcontext()


def configure(path: str | None) -> None:
    global _path
    _path = path


def _target() -> str | None:
    return _path or os.environ.get("TDAX_LOG")


def log_event(event: str, **fields) -> None:
    path = _target()
    if not path:
        return
    rec = {"ts": round(time.time(), 3), "event": event, **fields}
    try:
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
    except OSError:
        pass


def recording() -> bool:
    """Whether a profiler records, on any thread (not only this one's):
    the test behind ``span`` and the port's counters that cost a launch."""
    return _profiler._is_profiler_enabled


def span(name: str):
    """A ``tdax.<name>`` ``record_function`` range while a profiler
    records; otherwise a shared no-op context (no allocation, no sync)."""
    if recording():
        return torch.profiler.record_function("tdax." + name)
    return _OFF
