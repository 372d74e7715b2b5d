"""Leveled logging with DEBUG/TRACE verbosity.

Copy of the reference package's `utils/logging.py`, cut to what the port
calls: TRACE sits below logging.DEBUG so hot-path logs are free unless
enabled.
"""

from __future__ import annotations

import logging

TRACE = 5  # below logging.DEBUG (10)

logging.addLevelName(TRACE, "TRACE")


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"kvtorch.{name}")


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)

