"""Leveled logging (the level comes from SNN_TPU_LOG, default INFO)."""

from __future__ import annotations

import logging
import os

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
