"""Leveled logging with DEBUG/TRACE verbosity.

Copy of the reference package's `utils/logging.py`: TRACE sits below
logging.DEBUG so hot-path logs are free unless enabled, and `setup`
configures root logging for the service entry point.
"""

from __future__ import annotations

import logging
import os

TRACE = 5  # below logging.DEBUG (10)

logging.addLevelName(TRACE, "TRACE")


def get_logger(name: str) -> logging.Logger:
    return logging.getLogger(f"kvtorch.{name}")


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)


def setup(level: str | None = None) -> None:
    """Configure root logging once; level from arg or KVTPU_LOG_LEVEL env."""
    level_name = (level or os.environ.get("KVTPU_LOG_LEVEL", "INFO")).upper()
    resolved = TRACE if level_name == "TRACE" else getattr(logging, level_name, logging.INFO)
    logging.basicConfig(
        level=resolved,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
