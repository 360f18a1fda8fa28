"""Inter-process file locks for the fleet-shared cache directory (the
port's own copy of ``repro.explore.locks``).

A cache directory is shared by every service process pointed at it
(``REPRO_CACHE_DIR``), so manifest and archive writes are read-modify-
write cycles that can race: two services each reload, mutate their own
copy, and ``os.replace`` — the slower writer silently drops the faster
one's records.  ``file_lock`` arbitrates those cycles: writers take an
exclusive lock on a ``.lock`` sibling, reload the file *under the lock*,
merge their mutations into what is really on disk, and only then
replace.  The data file itself is still written atomically
(``atomic_savez``), so lock-free *readers* keep working unchanged —
locks order writers against writers, never block readers.

POSIX ``flock`` is used where available (the lock dies with the process,
so a SIGKILLed writer can never wedge the fleet); elsewhere an
exclusive-create lockfile with a stale-age takeover provides the same
mutual exclusion, with the takeover bounding how long a crashed writer's
leftover lockfile can block progress.
"""

from __future__ import annotations

import contextlib
import os
import time
import warnings
from pathlib import Path

try:
    import fcntl
except ImportError:                    # non-POSIX: lockfile fallback below
    fcntl = None

# how long a writer waits for the lock before giving up.  Cache writes
# are index-sized (milliseconds); a multi-second wait means a wedged
# peer, and failing loudly beats deadlocking a query.
DEFAULT_TIMEOUT_S = 30.0
_POLL_S = 0.01
# lockfile fallback only: a lockfile older than this is presumed to
# belong to a crashed writer and is taken over
_STALE_S = 60.0


class LockTimeout(TimeoutError):
    """The lock could not be acquired within the timeout."""


def lock_path(target) -> Path:
    """The lock sibling guarding writes to ``target`` (one lock per data
    file, so archives of different problems never serialize each
    other)."""
    target = Path(target)
    return target.with_name(target.name + ".lock")


@contextlib.contextmanager
def file_lock(path, timeout: float = DEFAULT_TIMEOUT_S):
    """Hold an exclusive inter-process lock on ``path`` (the lock file
    itself, typically ``lock_path(data_file)``) for the duration of the
    ``with`` block.  Re-entrant across *processes* only in the trivial
    sense that each holds its own descriptor — do not nest the same lock
    in one thread."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if fcntl is not None:
        fd = os.open(str(path), os.O_CREAT | os.O_RDWR, 0o644)
        try:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except OSError:
                    if time.monotonic() >= deadline:
                        raise LockTimeout(
                            f"could not lock {path} within {timeout:.0f}s "
                            f"(wedged peer process?)") from None
                    time.sleep(_POLL_S)
            try:
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)
        return
    # fallback: exclusive-create lockfile.  Unlike flock it survives its
    # owner's death, so a stale-age takeover keeps a crash from wedging
    # every later writer.
    deadline = time.monotonic() + timeout
    while True:
        try:
            fd = os.open(str(path), os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                         0o644)
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            break
        except FileExistsError:
            try:
                age = time.time() - path.stat().st_mtime
            except OSError:
                continue               # vanished between create and stat
            if age > _STALE_S:
                warnings.warn(f"taking over stale lock {path} "
                              f"(age {age:.0f}s)")
                path.unlink(missing_ok=True)
                continue
            if time.monotonic() >= deadline:
                raise LockTimeout(
                    f"could not lock {path} within {timeout:.0f}s") from None
            time.sleep(_POLL_S)
    try:
        yield
    finally:
        path.unlink(missing_ok=True)


__all__ = ["DEFAULT_TIMEOUT_S", "LockTimeout", "file_lock", "lock_path"]
