"""Structured stderr logging for the repro_torch CLIs (counterpart of
``repro.obs.log``).

Library code logs through ``get_logger(...)`` (children of the
``repro_torch`` logger) and stays silent unless a CLI entry point calls
``configure()`` — matching the historical behavior where progress
output only existed when a caller passed a ``progress=`` callback.
Diagnostics go to **stderr** so the machine-readable stdout lines the
CI jobs grep (sweep summary counts, JSON results) stay clean.

Level colors follow the ``NO_COLOR`` convention
(https://no-color.org): ANSI escapes are emitted only when the target
stream is a tty AND ``NO_COLOR`` is unset — piped/redirected output
and CI logs stay plain.

Verbosity mapping (the CLIs' ``-v`` / ``--quiet`` flags):
``-1`` -> WARNING, ``0`` -> INFO (default), ``>= 1`` -> DEBUG.
"""
from __future__ import annotations

import logging
import os
import sys

_ROOT_NAME = "repro_torch"
_FORMAT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"

_RESET = "\x1b[0m"
_LEVEL_COLORS = {
    logging.DEBUG: "\x1b[2m",       # dim
    logging.WARNING: "\x1b[33m",    # yellow
    logging.ERROR: "\x1b[31m",      # red
    logging.CRITICAL: "\x1b[1;31m",  # bold red
}


def _use_color(stream) -> bool:
    if os.environ.get("NO_COLOR") is not None:
        return False
    isatty = getattr(stream, "isatty", None)
    return bool(isatty and isatty())


class _ColorFormatter(logging.Formatter):
    """Wraps the formatted line in the record level's ANSI color
    (INFO stays uncolored — it is the default chatter)."""

    def format(self, record: logging.LogRecord) -> str:
        line = super().format(record)
        color = _LEVEL_COLORS.get(record.levelno)
        return f"{color}{line}{_RESET}" if color else line


def get_logger(name: str = _ROOT_NAME) -> logging.Logger:
    """A logger under the ``repro_torch`` hierarchy (silent until a CLI
    calls ``configure()``)."""
    if name != _ROOT_NAME and not name.startswith(_ROOT_NAME + "."):
        name = f"{_ROOT_NAME}.{name}"
    return logging.getLogger(name)


def configure(verbosity: int = 0, stream=None) -> logging.Logger:
    """Install (or replace) the stderr handler on the ``repro_torch`` root
    logger. Idempotent: repeated calls reconfigure rather than stack
    handlers."""
    root = logging.getLogger(_ROOT_NAME)
    for h in list(root.handlers):
        root.removeHandler(h)
    target = stream if stream is not None else sys.stderr
    handler = logging.StreamHandler(target)
    fmt_cls = _ColorFormatter if _use_color(target) else logging.Formatter
    handler.setFormatter(fmt_cls(_FORMAT, datefmt="%H:%M:%S"))
    root.addHandler(handler)
    if verbosity < 0:
        root.setLevel(logging.WARNING)
    elif verbosity == 0:
        root.setLevel(logging.INFO)
    else:
        root.setLevel(logging.DEBUG)
    root.propagate = False
    return root
