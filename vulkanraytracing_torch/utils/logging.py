"""Severity-prefixed logging to stderr.

Counterpart of ``vulkanraytracing_tpu/utils/logging.py``: errors, warnings
and info always print, debug lines only with ``VRT_DEBUG`` set, and timing
lines carry a ``[TIME]`` tag.  Everything goes to stderr, so machine-read
stdout (one-JSON-line scripts) is never interleaved.
"""

from __future__ import annotations

import os
import sys

_DEBUG = bool(os.environ.get("VRT_DEBUG", ""))


def _emit(prefix: str, *args: object) -> None:
    print(prefix, *args, file=sys.stderr, flush=True)


def log_e(*args: object) -> None:
    _emit("[ERROR]", *args)


def log_w(*args: object) -> None:
    _emit("[WARNING]", *args)


def log_i(*args: object) -> None:
    _emit("[INFO]", *args)


def log_d(*args: object) -> None:
    if _DEBUG:
        _emit("[DEBUG]", *args)


def log_t(*args: object) -> None:
    _emit("[TIME]", *args)
