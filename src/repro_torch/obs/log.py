"""Port of ``repro/obs/log.py``: stdlib-logging setup for the launchers, one
``repro_torch`` logger tree.

Library modules call :func:`get_logger` and log freely — with no handler
installed the records propagate to the root logger's ``lastResort``
handler (WARNING+ only), so tests and importers stay quiet.  CLIs that
want to *see* INFO output (``launch/train.py``)
call :func:`setup` once at entry; verbosity comes from the argument or
the ``REPRO_LOG_LEVEL`` environment variable.
"""
from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Union

__all__ = ["get_logger", "setup"]

_ROOT = "repro_torch"


def get_logger(name: str = "") -> logging.Logger:
    """A logger under the ``repro_torch.`` namespace
    (``get_logger("launch.train")`` -> ``repro_torch.launch.train``); pass
    a dotted module ``__name__`` verbatim —
    already-qualified names are kept."""
    if not name:
        return logging.getLogger(_ROOT)
    if name == _ROOT or name.startswith(_ROOT + "."):
        return logging.getLogger(name)
    return logging.getLogger(f"{_ROOT}.{name}")


def setup(level: Union[int, str, None] = None,
          stream=None, fmt: Optional[str] = None) -> logging.Logger:
    """Attach one stream handler to the ``repro_torch`` root (idempotent) and
    set its level — ``level`` arg > ``REPRO_LOG_LEVEL`` env > INFO."""
    if level is None:
        level = os.environ.get("REPRO_LOG_LEVEL", "INFO")
    if isinstance(level, str):
        level = getattr(logging, level.upper(), logging.INFO)
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not root.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(logging.Formatter(
            fmt or "%(asctime)s %(levelname).1s %(name)s: %(message)s",
            datefmt="%H:%M:%S"))
        root.addHandler(handler)
        root.propagate = False
    else:
        for h in root.handlers:
            h.setLevel(logging.NOTSET)
    return root
