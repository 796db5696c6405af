"""Structured logging.

Own copy of the JAX package's `utils/logging.py` (ref core/logging:
structured logs with per-category levels, size-rotated compressed files):
stdlib logging under `ytsaurus_tpu_torch.<Category>` with a
`StructuredFormatter` (one JSON object per line), per-category level
control via YTSAURUS_TPU_LOG_LEVEL / _LOG_CATEGORIES, and optional
rotated + gzipped file output via YTSAURUS_TPU_LOG_FILE
[+ _LOG_MAX_BYTES / _LOG_BACKUPS].
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any

_CONFIGURED = False


class _DynamicStderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time so redirection/capture works."""

    def __init__(self):
        logging.Handler.__init__(self)

    @property
    def stream(self):
        import sys
        return sys.stderr


class StructuredFormatter(logging.Formatter):
    """One JSON object per line: timestamp, level, category, message, fields."""

    def format(self, record: logging.LogRecord) -> str:
        entry: dict[str, Any] = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "category": record.name,
            "message": record.getMessage(),
        }
        fields = getattr(record, "fields", None)
        if fields:
            entry.update(fields)
        return json.dumps(entry, default=str)


def _configure() -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True
    root = logging.getLogger("ytsaurus_tpu_torch")
    level_name = os.environ.get("YTSAURUS_TPU_LOG_LEVEL", "WARNING").upper()
    root.setLevel(getattr(logging, level_name, logging.WARNING))
    handler = _DynamicStderrHandler()
    handler.setFormatter(StructuredFormatter())
    root.addHandler(handler)
    log_file = os.environ.get("YTSAURUS_TPU_LOG_FILE")
    if log_file:
        # One env var reaches EVERY daemon a launcher spawns, and the
        # rotating handler is not multi-process safe (a rotation in one
        # process unlinks the inode others still write).  Each process
        # therefore gets its own file: base-<pid>.ext.
        base, dot, ext = log_file.rpartition(".")
        if dot:
            log_file = f"{base}-{os.getpid()}.{ext}"
        else:
            log_file = f"{log_file}-{os.getpid()}"
        root.addHandler(make_rotating_handler(
            log_file,
            max_bytes=_env_int("YTSAURUS_TPU_LOG_MAX_BYTES", 64 << 20),
            backups=_env_int("YTSAURUS_TPU_LOG_BACKUPS", 3)))
    root.propagate = False
    # Per-category overrides: "Query=debug,Tablet=info"
    overrides = os.environ.get("YTSAURUS_TPU_LOG_CATEGORIES", "")
    for part in overrides.split(","):
        if "=" in part:
            category, _, lvl = part.partition("=")
            logging.getLogger(f"ytsaurus_tpu_torch.{category.strip()}").setLevel(
                getattr(logging, lvl.strip().upper(), logging.WARNING))


def _env_int(name: str, default: int) -> int:
    """Lenient like the module's other knobs: a malformed value falls
    back instead of aborting the first get_logger() call."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def make_rotating_handler(path: str, max_bytes: int = 64 << 20,
                          backups: int = 3) -> logging.Handler:
    """Size-rotated file handler whose rotated segments gzip on the way
    out (ref core/logging's compressed rotating writer): `path` is the
    live log; `path.1.gz` … `path.N.gz` are the history, oldest
    dropped past `backups`."""
    import gzip
    import shutil
    from logging.handlers import RotatingFileHandler

    class _GzRotatingHandler(RotatingFileHandler):
        def rotation_filename(self, default_name: str) -> str:
            return default_name + ".gz"

        def rotate(self, source: str, dest: str) -> None:
            with open(source, "rb") as src, \
                    gzip.open(dest, "wb") as out:
                shutil.copyfileobj(src, out)
            os.remove(source)

    handler = _GzRotatingHandler(path, maxBytes=max_bytes,
                                 backupCount=backups)
    handler.setFormatter(StructuredFormatter())
    return handler


def get_logger(category: str) -> logging.Logger:
    """Category logger ('Query', 'Tablet', 'Master', …)."""
    _configure()
    return logging.getLogger(f"ytsaurus_tpu_torch.{category}")


def log_event(logger: logging.Logger, level: int, message: str,
              **fields) -> None:
    """Structured event: message + key/value fields."""
    if logger.isEnabledFor(level):
        logger.log(level, message, extra={"fields": fields})
