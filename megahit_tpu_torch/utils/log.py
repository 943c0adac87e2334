"""Logging in the spirit of the reference's xinfo/xwarn macros
(reference src/utils/utils.h:84-104) plus the Python driver's dual
file/console handlers (reference src/megahit:468-483)."""

from __future__ import annotations

import logging
import sys

_LOGGER = logging.getLogger("megahit_tpu_torch")


def get_logger() -> logging.Logger:
    return _LOGGER


def setup_logging(log_file: str | None = None, verbose: bool = False) -> None:
    _LOGGER.setLevel(logging.DEBUG)
    _LOGGER.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setLevel(logging.DEBUG if verbose else logging.INFO)
    console.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
    _LOGGER.addHandler(console)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(logging.Formatter("%(asctime)s - %(message)s"))
        _LOGGER.addHandler(fh)


def xinfo(msg: str, *args) -> None:
    _LOGGER.info(msg, *args)


def xwarn(msg: str, *args) -> None:
    _LOGGER.warning(msg, *args)
