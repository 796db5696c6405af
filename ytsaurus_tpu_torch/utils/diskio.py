"""Small durable-file helpers shared by WAL/journal epoch state.

Own copy of the JAX package's `utils/diskio.py`.
"""

from __future__ import annotations

import os


def fsync_dir(path: str) -> None:
    """Make a rename/creation in `path` durable."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_epoch_file(path: str) -> tuple[int, str]:
    """(epoch, writer_id) from a fenced-epoch sidecar; (0, "") when
    missing/corrupt (corrupt = no fencing history, same as fresh)."""
    try:
        with open(path, "rb") as f:
            raw = f.read().decode().split()
        epoch = int(raw[0]) if raw else 0
        writer = raw[1] if len(raw) > 1 else ""
        return epoch, writer
    except (OSError, ValueError, IndexError):
        return 0, ""


def write_epoch_file(path: str, epoch: int, writer_id: str) -> None:
    """Atomic, fsync'd publish of (epoch, writer_id).  The parent
    directory is fsync'd after the rename: a granted/adopted fence epoch
    must survive a crash, or a node can forget a grant it already made."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(f"{epoch} {writer_id}".encode())
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    fsync_dir(parent)
