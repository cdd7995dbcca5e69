"""Dataset IO and minibatch streaming for the streaming SVGP path.

The port of :mod:`edrgp_tpu.data`, with its own copy of the native loader.
Datasets live on disk in a flat float32 format (:func:`write_dataset`; the
same bytes as the JAX package writes, so either package reads the other's
files), are memory-mapped by the native loader
(``edrgp_tpu_torch/native/dataloader.cpp``), and a producer thread gathers
shuffled minibatches into reusable buffers, so host batch assembly overlaps
device compute.

The loader is compiled at first use, never at import (:func:`build_native`),
into ``build/edrgp_tpu_torch/libedrgp_data-<hash>.so``, named after the
SHA-1 of its source and flags.  A missing compiler or a failed build or load
raises: the NumPy stream runs only when the caller asks for it with
``MMapDataset(path, force_numpy=True)``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue as _queue
import struct
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

from .ops.cuda._build import BUILD_DIR

__all__ = ["write_dataset", "MMapDataset", "native_available",
           "build_native", "library_path"]

_MAGIC = b"EDRG"
_VERSION = 1
_HEADER = struct.Struct("<4sIqq")  # magic, version, n_rows, row_floats

SOURCE = Path(__file__).with_name("native") / "dataloader.cpp"
#: ``native/Makefile``'s flags less ``-march=native``, so that one library
#: serves any host.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    """``libedrgp_data-<first 12 hex digits of the SHA-1 of the source and
    the flags>.so`` under ``build_dir``."""
    digest = hashlib.sha1(SOURCE.read_bytes())
    digest.update("\0".join(CXX_FLAGS).encode())
    return Path(build_dir) / f"libedrgp_data-{digest.hexdigest()[:12]}.so"


def build_native(compiler: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Compile the loader unless its library exists; returns its path.
    Raises ``RuntimeError`` when the compiler is missing or fails."""
    library = library_path(build_dir)
    if library.exists():
        return library
    library.parent.mkdir(parents=True, exist_ok=True)
    tmp = library.with_name(f"{library.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([compiler, *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed with code "
                               f"{proc.returncode}:\n{proc.stderr}")
        os.replace(tmp, library)     # atomic: a reader never sees half a file
    except FileNotFoundError as e:
        raise RuntimeError(f"C++ compiler {compiler!r} not found: the native "
                           "data loader cannot be built") from e
    finally:
        if tmp.exists():
            tmp.unlink()
    return library


def native_available() -> bool:
    """Whether the loader's library for this source is built already."""
    return library_path().exists()


def _load_lib() -> ctypes.CDLL:
    """The loader library, built on first use and loaded once per process."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    lib.edr_open.restype = ctypes.c_void_p
    lib.edr_open.argtypes = [ctypes.c_char_p]
    lib.edr_n_rows.restype = ctypes.c_int64
    lib.edr_n_rows.argtypes = [ctypes.c_void_p]
    lib.edr_row_floats.restype = ctypes.c_int64
    lib.edr_row_floats.argtypes = [ctypes.c_void_p]
    lib.edr_start_stream.restype = ctypes.c_int
    lib.edr_start_stream.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_uint64,
                                     ctypes.c_int]
    lib.edr_next_batch.restype = ctypes.c_int
    lib.edr_next_batch.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float)]
    lib.edr_close.restype = None
    lib.edr_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def write_dataset(path: str, X: np.ndarray, y: np.ndarray) -> None:
    """Write (X [N,Q], y [N]) as one row-major float32 file of [N, Q+1]."""
    X = np.ascontiguousarray(X, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.float32).reshape(-1, 1)
    if X.shape[0] != y.shape[0]:
        raise ValueError("X and y row counts differ")
    rows = np.concatenate([X, y], axis=1)
    with open(path, "wb") as f:
        f.write(_HEADER.pack(_MAGIC, _VERSION, rows.shape[0], rows.shape[1]))
        rows.tofile(f)


class MMapDataset:
    """Memory-mapped dataset with a background minibatch stream, served by
    the native loader (``force_numpy=True``: by a NumPy producer thread).

    >>> ds = MMapDataset("train.edrg")
    >>> for X_b, y_b in ds.batches(batch_size=4096, seed=0):
    ...     step(X_b, y_b)
    """

    def __init__(self, path: str, force_numpy: bool = False):
        self.path = path
        self._lib = None if force_numpy else _load_lib()
        self._handle = None
        if self._lib is not None:
            self._handle = self._lib.edr_open(path.encode())
            if not self._handle:
                raise OSError(f"native loader rejected {path!r}")
            self.n_rows = int(self._lib.edr_n_rows(self._handle))
            self.row_floats = int(self._lib.edr_row_floats(self._handle))
        else:
            with open(path, "rb") as f:
                raw = f.read(_HEADER.size)
            if len(raw) < _HEADER.size:
                raise OSError(f"bad dataset header in {path!r}")
            magic, version, n, rf = _HEADER.unpack(raw)
            if magic != _MAGIC or version != _VERSION:
                raise OSError(f"bad dataset header in {path!r}")
            self.n_rows, self.row_floats = int(n), int(rf)
            self._mm = np.memmap(path, dtype=np.float32, mode="r",
                                 offset=_HEADER.size,
                                 shape=(self.n_rows, self.row_floats))
        self.n_features = self.row_floats - 1

    # ---------------------------------------------------------------- rows
    def read_rows(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self._handle is not None:
            # random reads go through a throwaway numpy memmap view — the
            # native stream below is the hot path.
            mm = np.memmap(self.path, dtype=np.float32, mode="r",
                           offset=_HEADER.size,
                           shape=(self.n_rows, self.row_floats))
            rows = np.asarray(mm[idx])
        else:
            rows = np.asarray(self._mm[idx])
        return rows[:, :-1], rows[:, -1]

    # ------------------------------------------------------------- batches
    def batches(self, batch_size: int, seed: int = 0,
                with_replacement: bool = True,
                n_buffers: int = 4) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite stream of (X_b, y_b) minibatches (overlapped gather)."""
        if self._handle is None:
            yield from self._numpy_batches(batch_size, seed,
                                           with_replacement, n_buffers)
            return
        rc = self._lib.edr_start_stream(self._handle, batch_size,
                                        int(with_replacement), seed,
                                        n_buffers)
        if rc == -1:
            # one stream per native handle: a fresh mapping of the same
            # file serves another one
            fresh = MMapDataset(self.path)
            try:
                yield from fresh.batches(batch_size, seed, with_replacement,
                                         n_buffers)
            finally:
                fresh.close()
            return
        if rc != 0:
            raise RuntimeError(f"edr_start_stream failed: {rc}")
        buf = np.empty((batch_size, self.row_floats), dtype=np.float32)
        ptr = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        while True:
            self._lib.edr_next_batch(self._handle, ptr)
            rows = buf.copy()        # the next call overwrites buf
            yield rows[:, :-1], rows[:, -1]

    def _numpy_batches(self, batch_size, seed, with_replacement, n_buffers):
        """The same overlap structure in NumPy (producer thread)."""
        rng = np.random.default_rng(seed)
        q: _queue.Queue = _queue.Queue(maxsize=n_buffers)
        stop = threading.Event()

        def produce():
            perm = None
            cursor = 0
            while not stop.is_set():
                if with_replacement:
                    idx = rng.integers(0, self.n_rows, batch_size)
                else:
                    if perm is None or cursor + batch_size > self.n_rows:
                        perm = rng.permutation(self.n_rows)
                        cursor = 0
                    idx = perm[cursor:cursor + batch_size]
                    cursor += batch_size
                rows = np.asarray(self._mm[np.sort(idx)])
                # wait for room rather than drop the batch (the JAX
                # package's drops it after 1 s, so a slow consumer there
                # sees another stream)
                while not stop.is_set():
                    try:
                        q.put(rows, timeout=1.0)
                        break
                    except _queue.Full:
                        continue

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                rows = q.get()
                yield rows[:, :-1], rows[:, -1]
        finally:
            stop.set()

    def close(self):
        if self._handle is not None:
            self._lib.edr_close(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
