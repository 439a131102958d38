"""Indented hierarchical logging for search traces.

The port of ``flexflow_tpu/utils/logger.py``, unchanged: it is plain
Python. Analog of the reference's ``RecursiveLogger`` (``utils/recursive_logger.h``,
used throughout ``substitution.cc:2233``): each nested search phase indents
its log lines, controlled per-category like Legion logger levels
(``log_xfers``, ``log_dp``, ``log_sim`` ...).

Levels come from :func:`set_log_level` or the ``FF_LOG`` environment
variable, parsed at import — ``FF_LOG=dp=2,sim=1,xfers=0`` sets category
``dp`` to debug, ``sim`` to info, and silences ``xfers`` (the same
category=level spelling as Legion's ``-level`` flag). Logging is
thread-safe: serving and search log concurrently, so writes share one
lock and the indentation depth is tracked per thread.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Dict

# category -> min level printed (0 = silent, 1 = info, 2 = debug)
LOG_LEVELS: Dict[str, int] = {}

_PRINT_LOCK = threading.Lock()


def parse_ff_log(value: str) -> Dict[str, int]:
    """Parse ``"dp=2,sim=1,xfers=0"`` into ``{category: level}``.
    Malformed entries are skipped, never fatal — a bad FF_LOG must not
    break import."""
    out: Dict[str, int] = {}
    for part in (value or "").split(","):
        part = part.strip()
        if not part:
            continue
        cat, sep, lvl = part.partition("=")
        if not sep or not cat.strip():
            continue
        try:
            out[cat.strip()] = int(lvl.strip())
        except ValueError:
            continue
    return out


def set_log_level(category: str, level: int):
    LOG_LEVELS[category] = level


class RecursiveLogger:
    def __init__(self, category: str, stream=None):
        self.category = category
        self.stream = stream or sys.stderr
        self._local = threading.local()

    # depth is PER-THREAD: concurrent enter()s (a serving request inside
    # a search trace) must not corrupt each other's indentation
    @property
    def depth(self) -> int:
        return getattr(self._local, "depth", 0)

    @depth.setter
    def depth(self, value: int):
        self._local.depth = value

    def enabled(self, level: int = 1) -> bool:
        return LOG_LEVELS.get(self.category, 0) >= level

    @contextlib.contextmanager
    def enter(self, msg: str = "", level: int = 2):
        if msg:
            self.log(msg, level)
        self.depth += 1
        try:
            yield self
        finally:
            self.depth -= 1

    def log(self, msg: str, level: int = 1):
        if self.enabled(level):
            # one locked print: interleaved writers emit whole lines
            with _PRINT_LOCK:
                print(f"[{self.category}] {'  ' * self.depth}{msg}",
                      file=self.stream)


LOG_LEVELS.update(parse_ff_log(os.environ.get("FF_LOG", "")))
