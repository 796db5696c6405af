"""Structured logging.

Own copy of the JAX package's `utils/logging.py::get_logger` and
`log_event`: category loggers under `ytsaurus_tpu_torch.`, and events as a
message with key/value fields. The reference's file handlers and
structured formatter are not ported: the port logs through whatever
handlers the process configured.
"""

from __future__ import annotations

import logging


def get_logger(category: str) -> logging.Logger:
    """Category logger ('Query', 'Distributed', ...)."""
    return logging.getLogger(f"ytsaurus_tpu_torch.{category}")


def log_event(logger: logging.Logger, level: int, message: str,
              **fields) -> None:
    """Structured event: message + key/value fields."""
    if logger.isEnabledFor(level):
        logger.log(level, message, extra={"fields": fields})
