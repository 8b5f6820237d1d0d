"""Logging shim (port of ``ocrs_tpu.utils.log``): a module logger that host
applications configure through the root logger; the library never writes to
stdout behind their back unless debug printing was asked for."""

from __future__ import annotations

import logging

logger = logging.getLogger("ocrs_tpu_torch")


def log(msg: str, *args) -> None:
    """Info-level framework log message."""
    logger.info(msg, *args)


def debug(msg: str, *args) -> None:
    logger.debug(msg, *args)


def warn(msg: str, *args) -> None:
    logger.warning(msg, *args)
