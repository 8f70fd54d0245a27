"""Stdout logger factory (the reference's src/utilities/Logger.py:6-43);
the port's copy of ``bsed_tpu/utils/logger.py``."""
from __future__ import annotations

import logging
import sys


def create_logger(name: str, terminal_level=logging.INFO) -> logging.Logger:
    if isinstance(terminal_level, str):
        terminal_level = getattr(logging, terminal_level.upper(),
                                 logging.INFO)
    logger = logging.getLogger(name)
    logger.setLevel(terminal_level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
    logger.propagate = False
    return logger
