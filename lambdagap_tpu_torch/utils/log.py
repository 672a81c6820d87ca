"""Logging for lambdagap_tpu_torch.

Analog of the reference's ``Log`` class with levels and a pluggable
callback (reference: include/LightGBM/utils/log.h:43-60, used by the Python
package's ``register_logger``).
"""
from __future__ import annotations

import logging
import sys
from typing import Callable, Optional

_logger = logging.getLogger("lambdagap_tpu_torch")
if not _logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter("[LambdaGapTorch] [%(levelname)s] %(message)s"))
    _logger.addHandler(_handler)
    _logger.setLevel(logging.INFO)

_custom_callback: Optional[Callable[[str], None]] = None


def register_logger(logger: logging.Logger) -> None:
    """Replace the package logger (mirrors lightgbm.register_logger)."""
    global _logger
    _logger = logger


def set_verbosity(verbosity: int) -> None:
    """Map LightGBM-style verbosity int to logging level.

    <0: fatal only, 0: warning, 1: info, >1: debug
    (reference: include/LightGBM/config.h ``verbosity`` semantics).
    """
    if verbosity < 0:
        _logger.setLevel(logging.CRITICAL)
    elif verbosity == 0:
        _logger.setLevel(logging.WARNING)
    elif verbosity == 1:
        _logger.setLevel(logging.INFO)
    else:
        _logger.setLevel(logging.DEBUG)


def debug(msg: str, *args) -> None:
    _logger.debug(msg, *args)


def debug_enabled() -> bool:
    return _logger.isEnabledFor(logging.DEBUG)


def info(msg: str, *args) -> None:
    _logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    _logger.warning(msg, *args)


def fatal(msg: str, *args) -> None:
    """Log and raise — analog of Log::Fatal (reference: utils/log.h)."""
    text = msg % args if args else msg
    _logger.critical(text)
    raise RuntimeError(text)
