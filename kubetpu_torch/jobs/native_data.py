"""The native data loader (port of ``kubetpu/jobs/native_data.py``): ctypes
over the port's own ``kubetpu_torch/dataio/loader.cc``.

``TokenFile`` wraps an mmap'd flat binary corpus of little-endian token
ids; ``batches`` yields (tokens, targets) int32 arrays with targets
shifted by one (seq+1-token windows — the contract of ``jobs.data``'s
synthetic corpus, so a train loop swaps sources without changes). Window
offsets are drawn by a seeded numpy RNG on the host, the same draws as the
JAX package's for the same seed; the gather itself is C-speed over the OS
page cache. Batches stay host-side numpy: the train step uploads them.

The library builds itself at first use: the host C++ compiler (``g++``,
the Makefile's ``-O2 -Wall -Wextra -std=c++17 -shared -fPIC``) writes
``build/kubetpu_torch/libkubetpu_dataio-<hash of loader.cc>.so`` at the
root of the checkout (a per-pid temporary file, then ``os.replace``), so
nothing depends on ``make`` or ``_output/``. ``KUBETPU_TORCH_DATAIO_PATH``
names a prebuilt library instead. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "dataio" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubetpu_torch"
CXX_FLAGS = ["-O2", "-Wall", "-Wextra", "-std=c++17", "-shared", "-fPIC"]
PATH_ENV = "KUBETPU_TORCH_DATAIO_PATH"

_LIB: Optional[ctypes.CDLL] = None
# seconds the last first-use build took (0.0 when a current build was found)
BUILD_SECONDS: Optional[float] = None


def lib_path() -> Path:
    """The build of the loader: its file name hashes ``loader.cc``, so an
    edited source is never served from a stale build."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libkubetpu_dataio-{digest}.so"


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (g++) found: the native data "
                       "loader is built with one at first use")


def build() -> Path:
    """Compile the loader unless a current build exists -> its path."""
    global BUILD_SECONDS
    out = lib_path()
    if out.exists():
        BUILD_SECONDS = 0.0
        return out
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native data loader build failed (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_SECONDS = time.perf_counter() - t0
    return out


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        path = os.environ.get(PATH_ENV) or str(build())
        lib = ctypes.CDLL(path)
        lib.ktpu_open.restype = ctypes.c_void_p
        lib.ktpu_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ktpu_num_tokens.restype = ctypes.c_longlong
        lib.ktpu_num_tokens.argtypes = [ctypes.c_void_p]
        lib.ktpu_gather.restype = ctypes.c_int
        lib.ktpu_gather.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_longlong),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.ktpu_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def write_token_file(path: str, tokens: np.ndarray, dtype=np.uint16) -> None:
    """Serialize a 1-D token array into the loader's flat binary format.
    Refuses ids outside the dtype's range — a silent wraparound would
    produce a corpus that loads fine and trains on scrambled tokens."""
    tokens = np.asarray(tokens)
    info = np.iinfo(dtype)
    if tokens.size and (tokens.min() < info.min or tokens.max() > info.max):
        raise ValueError(
            f"token ids outside {np.dtype(dtype).name} range "
            f"[{info.min}, {info.max}]: min={tokens.min()}, max={tokens.max()}"
        )
    np.ascontiguousarray(tokens, dtype=dtype).tofile(path)


class TokenFile:
    """An mmap'd token corpus served by the native loader."""

    def __init__(self, path: str, dtype_bytes: int = 2):
        if dtype_bytes not in (2, 4):
            raise ValueError("dtype_bytes must be 2 (uint16) or 4 (uint32)")
        self._handle = _lib().ktpu_open(str(path).encode(), dtype_bytes)
        if not self._handle:
            raise OSError(f"cannot open token file {path!r}")
        self.num_tokens = int(_lib().ktpu_num_tokens(self._handle))
        # GC backstop: a dropped TokenFile must not leak the mmap (a loop
        # over many shards without close() would exhaust address space)
        self._finalizer = weakref.finalize(
            self, _lib().ktpu_close, self._handle
        )

    def close(self) -> None:
        if self._handle:
            self._finalizer.detach()
            _lib().ktpu_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def gather(self, offsets: np.ndarray, seq: int) -> np.ndarray:
        """Rows of ``seq`` tokens at the given token offsets -> (n, seq)
        int32. Out-of-range offsets raise (the C side would skip them —
        silent row loss is worse than an error)."""
        if not self._handle:
            raise ValueError("TokenFile is closed")
        offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        if offsets.ndim != 1:
            raise ValueError("offsets must be 1-D")
        if ((offsets < 0) | (offsets + seq > self.num_tokens)).any():
            raise ValueError("offset window out of range")
        out = np.empty((len(offsets), seq), np.int32)
        n = _lib().ktpu_gather(
            self._handle,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
            len(offsets),
            seq,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if n != len(offsets):
            raise RuntimeError(f"native gather wrote {n}/{len(offsets)} rows")
        return out

    def batches(
        self, batch: int, seq: int, seed: int = 0,
        worker: int = 0, num_workers: int = 1,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Endless (tokens, targets) int32 batches; targets are tokens
        shifted by one (seq+1-token windows). Deterministic per seed.

        ``(worker, num_workers)`` shards the corpus for multi-process data
        parallelism: each worker draws windows only from its contiguous
        1/num_workers span of the token stream (disjoint data, not just
        different seeds), with the worker id folded into the RNG."""
        if not 0 <= worker < num_workers:
            raise ValueError(f"worker {worker} not in [0, {num_workers})")
        # plain `seed` for the single-worker default keeps the streams of
        # unsharded runs reproducible
        rng = np.random.default_rng(
            seed if num_workers == 1 else (seed, worker))
        span = self.num_tokens // num_workers
        lo = worker * span
        hi = lo + span - (seq + 1)
        if hi < lo:
            raise ValueError("corpus shard shorter than one sequence")
        while True:
            offsets = rng.integers(lo, hi + 1, size=batch)
            rows = self.gather(offsets, seq + 1)
            yield rows[:, :-1], rows[:, 1:]
