"""Crash-safe small-file I/O shared across the stack (stdlib only).

State that must survive an unluckily-timed kill (trace stores, block
tables, streaming band checkpoints) is written through these
primitives, the reference package's own, which give the standard
guarantees:

* :func:`atomic_write_text` — write-temp + flush + ``fsync`` +
  ``os.replace``: readers see either the old file or the complete new
  one, never a torn write;
* :func:`fsync_append` — append one line and force it to disk: the
  write-ahead idiom (a record is durable before the state it describes
  is trusted);
* :func:`line_checksum` / :func:`checksum_ok` — per-record crc32 for
  JSONL stores, so a torn tail line is *detected* (and counted), not
  just skipped.
"""
from __future__ import annotations

import os
import tempfile
import zlib


def atomic_write_text(path: str, text: str) -> None:
    """Replace ``path`` with ``text`` atomically (same-directory temp
    file, fsync'd before the rename, so a crash leaves either the old
    or the new content — never a prefix)."""
    path = os.fspath(path)
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=os.path.basename(path) + ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_append(path: str, line: str) -> None:
    """Append ``line`` (newline added if missing) and fsync — the
    write-ahead journal idiom.  The record is on disk when this
    returns; a crash mid-append leaves at most one torn tail line,
    which checksummed readers detect."""
    if not line.endswith("\n"):
        line += "\n"
    with open(path, "a") as f:
        f.write(line)
        f.flush()
        os.fsync(f.fileno())


def line_checksum(payload: str) -> int:
    """crc32 of a record's canonical payload text."""
    return zlib.crc32(payload.encode("utf-8")) & 0xFFFFFFFF


def checksum_ok(payload: str, crc: int) -> bool:
    return line_checksum(payload) == (int(crc) & 0xFFFFFFFF)
