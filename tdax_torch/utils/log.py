"""Structured JSONL event log (port of ``tdax/utils/log.py``).

Set ``TDAX_LOG=path.jsonl`` (or call ``configure``) to append one JSON
object per event: ``{"ts", "event", **fields}``.  Nothing is written
when neither is set.
"""

from __future__ import annotations

import json
import os
import time

_path: str | None = None


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
