"""Stdlib logging helpers (reference: utils/logging_utils.py:12-26)."""

from __future__ import annotations

import logging
import os


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    level = os.environ.get("HIPPORAG_TPU_LOG_LEVEL")
    if level:
        logger.setLevel(level.upper())
    return logger
