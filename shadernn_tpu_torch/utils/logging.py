"""Leveled logging (the level comes from SNN_TPU_LOG, default INFO), with
the rate-limited helpers of the JAX package's utils/logging.py."""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Tuple

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    level_name = os.environ.get("SNN_TPU_LOG", "INFO").upper()
    logging.basicConfig(level=getattr(logging, level_name, logging.INFO), format=_FMT)
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    return logging.getLogger(name)


_last_emit: Dict[Tuple[str, str], float] = {}
_first_n: Dict[Tuple[str, str], int] = {}


def log_every_n_sec(logger: logging.Logger, seconds: float, msg: str, *args) -> None:
    """Emit at most once every `seconds` per (logger, msg) pair."""
    key = (logger.name, msg)
    now = time.monotonic()
    if now - _last_emit.get(key, -1e18) >= seconds:
        _last_emit[key] = now
        logger.info(msg, *args)


def log_first_n(logger: logging.Logger, n: int, msg: str, *args) -> None:
    """Emit only the first `n` occurrences per (logger, msg) pair."""
    key = (logger.name, msg)
    count = _first_n.get(key, 0)
    if count < n:
        _first_n[key] = count + 1
        logger.info(msg, *args)
