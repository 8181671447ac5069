"""Stage-tagged logging: one stdlib logger per stage (``raytpu.<stage>``)
with thread names in the format, its level from ``RAYTPU_LOG`` (default
WARNING), as the JAX package's ``utils/log.py`` sets it up."""

from __future__ import annotations

import logging
import os

_FORMAT = "%(asctime)s %(levelname).1s [%(name)s|%(threadName)s] %(message)s"
_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("RAYTPU_LOG", "WARNING").upper()
    logging.basicConfig(level=getattr(logging, level, logging.WARNING),
                        format=_FORMAT, datefmt="%H:%M:%S")
    _configured = True


def get_logger(stage: str) -> logging.Logger:
    _configure()
    return logging.getLogger(f"raytpu.{stage}")
