"""Leveled logger.

Parity with the reference's ``util/log.h`` / ``src/util/log.cpp`` logger
(``Log::{Debug,Info,Error,Fatal}``, optional file sink; SURVEY.md §2.21),
implemented over Python ``logging`` so it composes with absl/jax logging.

``fatal`` logs and raises (the reference aborts the process; raising is the
single-controller equivalent that tests can assert on).
"""

from __future__ import annotations

import logging
import sys

__all__ = ["Log", "LogLevel", "configure"]


class LogLevel:
    DEBUG = logging.DEBUG
    INFO = logging.INFO
    ERROR = logging.ERROR
    FATAL = logging.CRITICAL


_LEVELS = {
    "debug": LogLevel.DEBUG,
    "info": LogLevel.INFO,
    "error": LogLevel.ERROR,
    "fatal": LogLevel.FATAL,
}

_logger = logging.getLogger("multiverso_tpu_torch")
_configured = False


class FatalError(RuntimeError):
    """Raised by Log.fatal (reference behavior: abort)."""


def configure(level: str = "info", log_file: str = "") -> None:
    """(Re)configure sinks; mirrors the reference's ResetLogFile."""
    global _configured
    for h in list(_logger.handlers):
        _logger.removeHandler(h)
    fmt = logging.Formatter(
        "[%(levelname).1s %(asctime)s multiverso_tpu_torch] %(message)s",
        datefmt="%H:%M:%S",
    )
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    _logger.addHandler(sh)
    if log_file:
        fh = logging.FileHandler(log_file)
        fh.setFormatter(fmt)
        _logger.addHandler(fh)
    _logger.setLevel(_LEVELS.get(level.lower(), LogLevel.INFO))
    _logger.propagate = False
    _configured = True


def _ensure() -> None:
    if not _configured:
        configure()


class Log:
    """Static facade matching the reference's Log class."""

    @staticmethod
    def debug(msg: str, *args) -> None:
        _ensure()
        _logger.debug(msg, *args)

    @staticmethod
    def info(msg: str, *args) -> None:
        _ensure()
        _logger.info(msg, *args)

    @staticmethod
    def error(msg: str, *args) -> None:
        _ensure()
        _logger.error(msg, *args)

    @staticmethod
    def fatal(msg: str, *args) -> None:
        _ensure()
        _logger.critical(msg, *args)
        raise FatalError(msg % args if args else msg)
