"""Host-side filesystem helpers: transparent gzip IO, atomic writes,
success-file checkpointing and rerun modes.

Counterparts in the reference: ext/sys.rs (gz/lz4/plain autodetect, file
merging), command/mod.rs:132-206 (`Rerun`), :280-282 (`write_success_file`),
command/paths.rs (on-disk layout).
"""
from __future__ import annotations

import enum
import gzip
import hashlib
import io
import os
import queue
import shutil
import threading
from contextlib import contextmanager
from pathlib import Path

SUCCESS = "success"


class Prefetch:
    """Runs a generator on a thread of its own, started at once, keeping up
    to `depth` items ready: inflate and the native parser release the GIL,
    so the producer overlaps the consumer's work.  Iterating yields the
    generator's items; an exception it raises (e.g. fastx.MaxLenExceeded)
    is raised in the consumer.  `close()` (or leaving a `with` block) stops
    the thread, which closes the generator, and joins it: no thread
    outlives its consumer."""

    _END, _ERR = object(), object()

    def __init__(self, gen, depth: int = 2, name: str = "prefetch"):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._done = False
        self._thread = threading.Thread(target=self._run, args=(gen,),
                                        name=name, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, gen):
        try:
            for item in gen:
                if not self._put(item):
                    return
        except BaseException as exc:      # noqa: BLE001 — re-raised by next
            self._put((self._ERR, exc))
            return
        finally:
            gen.close()
        self._put(self._END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._done = True
            raise StopIteration
        if type(item) is tuple and len(item) == 2 and item[0] is self._ERR:
            self._done = True
            raise item[1]
        return item

    def close(self) -> None:
        self._done = True
        self._stop.set()
        while self._thread.is_alive():      # unblock a put, then join
            try:
                self._q.get(timeout=0.01)
            except queue.Empty:
                pass
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def smart_open(path):
    """Opens a text file for reading; transparently handles .gz (by magic
    bytes).  Closing it closes the file (`smart_open_bytes`)."""
    return io.TextIOWrapper(smart_open_bytes(path))


class _ClosingGzipFile(gzip.GzipFile):
    """GzipFile that also closes the raw file object it wraps (plain
    GzipFile(fileobj=...) leaks the underlying fd on close)."""

    def close(self):
        raw = self.fileobj
        try:
            super().close()
        finally:
            if raw is not None:
                raw.close()


def smart_open_bytes(path):
    path = Path(path)
    f = open(path, "rb")
    try:
        magic = f.read(2)
        f.seek(0)
    except OSError:
        f.close()
        raise
    if magic == b"\x1f\x8b":
        return _ClosingGzipFile(fileobj=f, mode="rb")
    return f


def smart_create(path, binary: bool = False):
    """Creates a file for writing; gzip-compresses if the name ends in .gz."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        f = gzip.open(path, "wb" if binary else "wt", compresslevel=4)
    else:
        f = open(path, "wb" if binary else "w")
    return f


@contextmanager
def atomic_write(path, binary: bool = False):
    """Writes to `<path>.tmp` and renames on success (reference pattern at
    genotype.rs:662-682)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    f = smart_create(tmp, binary=binary)
    try:
        yield f
        f.close()
        os.replace(tmp, path)
    except BaseException:
        f.close()
        tmp.unlink(missing_ok=True)
        raise


def file_sha(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def write_success(directory) -> None:
    (Path(directory) / SUCCESS).write_text("")


def has_success(directory) -> bool:
    return (Path(directory) / SUCCESS).exists()


class Rerun(enum.Enum):
    """Rerun modes (reference command/mod.rs:132-206):
    ALL   — remove the output directory and recompute everything;
    PART  — keep successfully completed sub-results, recompute the rest;
    NONE  — only run if nothing was computed before.
    """
    ALL = "all"
    PART = "part"
    NONE = "none"

    @classmethod
    def parse(cls, s: str) -> "Rerun":
        s = s.lower()
        for v in cls:
            if v.value.startswith(s):
                return v
        raise ValueError(f"Unknown rerun mode {s!r}")

    def prepare_dir(self, directory, keep: tuple = ()) -> bool:
        """Prepares `directory`; returns True if (re)computation is needed.

        `keep`: file names preserved when clearing an *incomplete* directory
        under part/none reruns — checkpoints a crashed run left behind
        (reference genotype.rs:662-682 reuses recruited reads.fq.gz).
        --rerun all always starts from a pristine directory.
        """
        directory = Path(directory)
        if not directory.exists():
            directory.mkdir(parents=True)
            return True
        done = has_success(directory)
        if self is Rerun.NONE and done:
            return False
        if self is Rerun.PART and done:
            return False
        if self is Rerun.ALL or not keep:
            shutil.rmtree(directory)
            directory.mkdir(parents=True)
            return True
        for child in directory.iterdir():
            if child.name in keep:
                continue
            if child.is_dir():
                shutil.rmtree(child)
            else:
                child.unlink()
        return True


def merge_files(first, rest) -> None:
    """Appends `rest` files to `first` and removes them (ext/sys.rs:246)."""
    with open(first, "ab") as out:
        for path in rest:
            with open(path, "rb") as f:
                shutil.copyfileobj(f, out)
            os.unlink(path)
