"""daft_tpu_torch.native — ctypes bindings to the C++ host-kernel library.

The host data plane's hot spots that have no device counterpart: row
hashing (xxh64, murmur3), hash and partition-id fanout, MinHash,
HyperLogLog, hash-join probe tables and the BPE vocabulary (reference:
``daft_tpu/native/``, whose ``src/kernels.cpp`` this package carries a
copy of).

The library is built with ``g++`` at first use, never at import, into
``daft_tpu_torch/_build/`` (git-ignored) under a name keyed by the
source's sha256, ``platform.machine()`` and the CPU flags line (it is
compiled with ``-march=native``). The build writes a temporary file and
renames it into place, so processes that build at once never load a torn
library.

``DAFT_TORCH_NATIVE`` (on by default) decides which implementation runs.
On, a build or load that fails raises :class:`NativeBuildError` with the
compiler's last 2,000 characters; nothing falls back. ``0``: the numpy
twins run (``series._xxh64_var``, ``series._minhash_fallback``,
:func:`hll_add_numpy` / :func:`hll_estimate_numpy`, a stable argsort for
the fanout). They compute the library's values bit for bit, so an answer
never depends on whether ``g++`` ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import platform
import subprocess
import tempfile
import threading
import time

import numpy as np

from .. import knobs

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "src", "kernels.cpp")
#: where the library is built (the tests point it at a scratch directory)
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-Wall",
             "-march=native"]
#: the null-row hash of ``dn_hash_var`` / ``dn_hash_fixed`` (seed 0)
NULL_HASH = np.uint64(0x9E3779B97F4A7C15)

_lib = None
_lib_lock = threading.Lock()
#: seconds the first :func:`library` call took (the build where needed and
#: the load); ``built`` says whether this process compiled it
build_seconds = 0.0
built = False


class NativeBuildError(RuntimeError):
    """The native library did not build or load with DAFT_TORCH_NATIVE on."""


def enabled() -> bool:
    return knobs.env_bool("DAFT_TORCH_NATIVE")


def stamp() -> str:
    """The library's key: source sha256, machine and CPU flags line (the
    reference's ``native/__init__.py:_src_hash``): a library built with
    ``-march=native`` on another CPU is never loaded here."""
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(platform.machine().encode())
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    h.update(line.encode())
                    break
    except OSError:
        pass
    return h.hexdigest()


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libdaft_torch_native_{stamp()[:16]}.so")


def _compile(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            r = subprocess.run([CXX, *CXX_FLAGS, "-o", tmp, SRC],
                               capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"native library build failed: {e}") from e
        if r.returncode != 0:
            msg = (r.stderr or r.stdout or "")[-2000:]
            raise NativeBuildError(
                f"native library build failed ({CXX} exit "
                f"{r.returncode}):\n{msg}")
        os.rename(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64, u64, i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32
    lib.dn_xxh64.argtypes = [u8p, i64, u64]
    lib.dn_xxh64.restype = u64
    lib.dn_hash_fixed.argtypes = [u8p, i64, i64, u8p, u64, u64p]
    lib.dn_hash_var.argtypes = [i64p, u8p, i64, u8p, u64, u64p]
    lib.dn_hash_combine.argtypes = [u64p, u64p, i64, u64p]
    lib.dn_murmur3_32.argtypes = [u8p, i64, ctypes.c_uint32]
    lib.dn_murmur3_32.restype = ctypes.c_uint32
    lib.dn_fanout_hash.argtypes = [u64p, i64, i64, i64p, i64p, i64p]
    lib.dn_fanout_pid.argtypes = [i64p, i64, i64, i64p, i64p]
    lib.dn_minhash.argtypes = [i64p, u8p, i64, u8p, i32, i32, u64, u32p]
    lib.dn_hll_add.argtypes = [u8p, i32, u64p, i64]
    lib.dn_hll_merge.argtypes = [u8p, u8p, i64]
    lib.dn_hll_estimate.argtypes = [u8p, i32]
    lib.dn_hll_estimate.restype = ctypes.c_double
    lib.dn_probe_build.argtypes = [u64p, i64]
    lib.dn_probe_build.restype = ctypes.c_void_p
    lib.dn_probe_run.argtypes = [ctypes.c_void_p, u64p, i64, i64p, i64p,
                                 i64, i64p]
    lib.dn_probe_run.restype = i64
    lib.dn_probe_free.argtypes = [ctypes.c_void_p]
    lib.dn_bpe_build.argtypes = [i64p, u8p, i32p, i64]
    lib.dn_bpe_build.restype = ctypes.c_void_p
    lib.dn_bpe_encode.argtypes = [ctypes.c_void_p, u8p, i64, i32p]
    lib.dn_bpe_encode.restype = i64
    lib.dn_bpe_encode_batch.argtypes = [ctypes.c_void_p, i64p, u8p, i64,
                                        i32p, i64p]
    lib.dn_bpe_encode_batch.restype = i64
    lib.dn_bpe_free.argtypes = [ctypes.c_void_p]


def library():
    """The loaded library, built first where this machine has none: raises
    :class:`NativeBuildError` when the build or the load fails, and when
    ``DAFT_TORCH_NATIVE`` is off."""
    global _lib, build_seconds, built
    if _lib is not None:
        return _lib
    if not enabled():
        raise NativeBuildError("DAFT_TORCH_NATIVE=0: the native library is "
                               "off; callers take the numpy twins")
    with _lib_lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        path = library_path()
        did_build = not os.path.exists(path)
        if did_build:
            # daft-lint: allow(blocking-under-lock) -- build once: every
            # other thread that asks for the library waits for this build
            _compile(path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeBuildError(
                f"native library load failed: {e}") from e
        _bind(lib)
        build_seconds = time.perf_counter() - t0
        built = did_build
        _lib = lib
    return _lib


def available() -> bool:
    """True when the library runs (built and loaded, which this call does
    at first use), False when ``DAFT_TORCH_NATIVE`` is off. A failed build
    raises."""
    if not enabled():
        return False
    library()
    return True


# ---------------------------------------------------------------- helpers

def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


_NULL_U8P = ctypes.POINTER(ctypes.c_uint8)()


def _valid_arr(valid):
    """The validity as uint8; the caller holds the array for the C call
    (a ctypes pointer keeps no buffer alive)."""
    if valid is None:
        return None
    return np.ascontiguousarray(valid, dtype=np.uint8)


def _vp(valid_u8):
    return _NULL_U8P if valid_u8 is None else _ptr(valid_u8, ctypes.c_uint8)


# ---------------------------------------------------------------- hashing

def xxh64(data: bytes, seed: int = 0) -> int:
    buf = np.frombuffer(data, dtype=np.uint8) if data \
        else np.zeros(1, dtype=np.uint8)
    buf = np.ascontiguousarray(buf)
    return int(library().dn_xxh64(_ptr(buf, ctypes.c_uint8), len(data),
                                  seed))


def murmur3_32(data: bytes, seed: int = 0) -> int:
    buf = np.ascontiguousarray(np.frombuffer(data, dtype=np.uint8)) \
        if data else np.zeros(1, dtype=np.uint8)
    return int(library().dn_murmur3_32(_ptr(buf, ctypes.c_uint8), len(data),
                                       seed))


def hash_fixed(data: np.ndarray, valid, seed: int = 0) -> np.ndarray:
    """xxh64 of each fixed-width row of a contiguous 1-D array."""
    lib = library()
    data = np.ascontiguousarray(data)
    n = len(data)
    out = np.empty(n, dtype=np.uint64)
    valid_u8 = _valid_arr(valid)
    lib.dn_hash_fixed(
        data.view(np.uint8).reshape(n, -1).ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)) if n else _NULL_U8P,
        n, data.itemsize, _vp(valid_u8), seed, _ptr(out, ctypes.c_uint64))
    return out


def hash_var(offsets: np.ndarray, data: np.ndarray, valid,
             seed: int = 0) -> np.ndarray:
    """xxh64 of each variable-width row (Arrow large_binary layout); a null
    row hashes to ``NULL_HASH ^ seed``."""
    lib = library()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if not len(data):
        data = np.zeros(1, dtype=np.uint8)
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.uint64)
    valid_u8 = _valid_arr(valid)
    lib.dn_hash_var(_ptr(offsets, ctypes.c_int64), _ptr(data, ctypes.c_uint8),
                    n, _vp(valid_u8), seed, _ptr(out, ctypes.c_uint64))
    return out


def hash_combine(h: np.ndarray, seed: np.ndarray) -> np.ndarray:
    """splitmix64 of ``h ^ seed`` per row (a multi-column key's fold)."""
    lib = library()
    h = np.ascontiguousarray(h, dtype=np.uint64)
    seed = np.ascontiguousarray(seed, dtype=np.uint64)
    out = np.empty(len(h), dtype=np.uint64)
    lib.dn_hash_combine(_ptr(h, ctypes.c_uint64), _ptr(seed, ctypes.c_uint64),
                        len(h), _ptr(out, ctypes.c_uint64))
    return out


# ---------------------------------------------------------------- fanout

def fanout_hash(h: np.ndarray, nparts: int):
    """→ (counts[nparts], gather indices[n]): partition p's rows are
    ``indices[starts[p]:starts[p] + counts[p]]``, each in row order."""
    lib = library()
    h = np.ascontiguousarray(h, dtype=np.uint64)
    n = len(h)
    counts = np.empty(nparts, dtype=np.int64)
    indices = np.empty(n, dtype=np.int64)
    lib.dn_fanout_hash(_ptr(h, ctypes.c_uint64), n, nparts,
                       _ptr(counts, ctypes.c_int64),
                       _ptr(indices, ctypes.c_int64),
                       ctypes.POINTER(ctypes.c_int64)())
    return counts, indices


def fanout_pid(pid: np.ndarray, nparts: int):
    """The counting sort of precomputed partition ids: (counts, stable
    gather indices)."""
    if not available():
        pid = np.asarray(pid, dtype=np.int64)
        # a 16-bit key takes numpy's radix sort (stable, linear)
        order = np.argsort(pid.astype(np.uint16) if nparts <= 1 << 16
                           else pid, kind="stable")
        return np.bincount(pid, minlength=nparts).astype(np.int64), order
    lib = library()
    pid = np.ascontiguousarray(pid, dtype=np.int64)
    n = len(pid)
    counts = np.empty(nparts, dtype=np.int64)
    indices = np.empty(n, dtype=np.int64)
    lib.dn_fanout_pid(_ptr(pid, ctypes.c_int64), n, nparts,
                      _ptr(counts, ctypes.c_int64),
                      _ptr(indices, ctypes.c_int64))
    return counts, indices


# ---------------------------------------------------------------- minhash

def minhash(offsets: np.ndarray, data: np.ndarray, valid, num_hashes: int,
            ngram_size: int = 1, seed: int = 1) -> np.ndarray:
    """→ the uint32 ``[n, num_hashes]`` MinHash signatures (word shingles
    of ``ngram_size``; a null row or one without words is all 0xFFFFFFFF)."""
    lib = library()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    if not len(data):
        data = np.zeros(1, dtype=np.uint8)
    n = len(offsets) - 1
    out = np.empty((n, num_hashes), dtype=np.uint32)
    valid_u8 = _valid_arr(valid)
    lib.dn_minhash(_ptr(offsets, ctypes.c_int64), _ptr(data, ctypes.c_uint8),
                   n, _vp(valid_u8), num_hashes, ngram_size, seed,
                   _ptr(out, ctypes.c_uint32))
    return out


# ---------------------------------------------------------------- HyperLogLog

def _bit_length_u64(x: np.ndarray) -> np.ndarray:
    """Exact bit length of each uint64 (0 for 0): each 32-bit half is exact
    in a float64, whose ``frexp`` exponent is its bit length."""
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
    return np.where(hi > 0, 32 + np.frexp(hi)[1], np.frexp(lo)[1])


def hll_add_numpy(registers: np.ndarray, p: int, hashes: np.ndarray) -> None:
    """``dn_hll_add`` in numpy: the top ``p`` bits pick the register, the
    leading zeros of the rest (plus one) are its candidate rank."""
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    if not len(h):
        return
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    rest = h << np.uint64(p)
    rho = np.where(rest == 0, 64 - p + 1,
                   64 - _bit_length_u64(rest) + 1).astype(np.uint8)
    np.maximum.at(registers, idx, rho)


def hll_estimate_numpy(registers: np.ndarray, p: int) -> float:
    """``dn_hll_estimate`` in numpy, to the last bit: the register sum is
    accumulated in the C loop's order (``cumsum`` is sequential)."""
    m = 1 << p
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(
        m, 0.7213 / (1.0 + 1.079 / m))
    terms = np.ldexp(1.0, -registers.astype(np.int32))
    total = float(np.cumsum(terms)[-1])
    zeros = int(np.count_nonzero(registers == 0))
    e = alpha * m * m / total
    if e <= 2.5 * m and zeros > 0:
        e = m * math.log(m / zeros)
    return e


class HyperLogLog:
    """Dense HLL over u64 hashes (default p = 14: 16Ki registers, ~0.8%
    relative error), mergeable across partitions. ``native`` picks the
    library (True) or the numpy twin (False); None follows
    ``DAFT_TORCH_NATIVE``. Both give the same registers and estimate."""

    def __init__(self, p: int = 14, registers: np.ndarray = None,
                 native=None):
        self.p = p
        self.registers = registers if registers is not None \
            else np.zeros(1 << p, dtype=np.uint8)
        self.native = available() if native is None else native

    def add_hashes(self, hashes: np.ndarray) -> "HyperLogLog":
        hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
        if self.native:
            library().dn_hll_add(_ptr(self.registers, ctypes.c_uint8), self.p,
                                 _ptr(hashes, ctypes.c_uint64), len(hashes))
        else:
            hll_add_numpy(self.registers, self.p, hashes)
        return self

    def merge(self, other: "HyperLogLog") -> "HyperLogLog":
        if self.native:
            library().dn_hll_merge(_ptr(self.registers, ctypes.c_uint8),
                                   _ptr(other.registers, ctypes.c_uint8),
                                   len(self.registers))
        else:
            np.maximum(self.registers, other.registers, out=self.registers)
        return self

    def estimate(self) -> float:
        if self.native:
            return float(library().dn_hll_estimate(
                _ptr(self.registers, ctypes.c_uint8), self.p))
        return hll_estimate_numpy(self.registers, self.p)


# ---------------------------------------------------------------- probe table

class ProbeTable:
    """Chained hash table over build-side row hashes; probing emits the
    candidate (probe_idx, build_idx) pairs, whose keys the caller checks."""

    def __init__(self, build_hashes: np.ndarray):
        self._lib = library()
        h = np.ascontiguousarray(build_hashes, dtype=np.uint64)
        self._n_build = len(h)
        self._handle = self._lib.dn_probe_build(_ptr(h, ctypes.c_uint64),
                                                len(h))

    def probe(self, probe_hashes: np.ndarray):
        """→ (probe_idx[int64], build_idx[int64]) candidate pairs."""
        h = np.ascontiguousarray(probe_hashes, dtype=np.uint64)
        n = len(h)
        state = np.array([0, -1], dtype=np.int64)
        cap = max(1024, n)
        chunks_p, chunks_b = [], []
        while state[0] < n:
            op = np.empty(cap, dtype=np.int64)
            ob = np.empty(cap, dtype=np.int64)
            wrote = self._lib.dn_probe_run(
                self._handle, _ptr(h, ctypes.c_uint64), n,
                _ptr(op, ctypes.c_int64), _ptr(ob, ctypes.c_int64), cap,
                _ptr(state, ctypes.c_int64))
            chunks_p.append(op[:wrote])
            chunks_b.append(ob[:wrote])
            if wrote < cap and state[0] >= n:
                break
        if not chunks_p:
            e = np.empty(0, dtype=np.int64)
            return e, e.copy()
        return np.concatenate(chunks_p), np.concatenate(chunks_b)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dn_probe_free(self._handle)
            self._handle = None


# ---------------------------------------------------------------- BPE

class BpeVocab:
    """A BPE vocabulary (byte sequence → rank) and the greedy lowest-rank
    merge encoding, the tokenize hot loop."""

    def __init__(self, tokens, ranks):
        """tokens: list[bytes]; ranks: the parallel list[int]."""
        self._lib = library()
        lens = np.fromiter((len(t) for t in tokens), dtype=np.int64,
                           count=len(tokens))
        offs = np.zeros(len(tokens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        data = np.ascontiguousarray(np.frombuffer(b"".join(tokens),
                                                  dtype=np.uint8)) \
            if tokens else np.empty(0, dtype=np.uint8)
        r = np.ascontiguousarray(ranks, dtype=np.int32)
        self._handle = self._lib.dn_bpe_build(
            _ptr(offs, ctypes.c_int64),
            _ptr(data, ctypes.c_uint8) if len(data) else _NULL_U8P,
            _ptr(r, ctypes.c_int32), len(tokens))

    def encode(self, piece: bytes):
        """→ int32 ids, or None when some byte sequence has no rank."""
        n = len(piece)
        if n == 0:
            return np.empty(0, dtype=np.int32)
        buf = np.ascontiguousarray(np.frombuffer(piece, dtype=np.uint8))
        out = np.empty(n, dtype=np.int32)
        wrote = self._lib.dn_bpe_encode(self._handle,
                                        _ptr(buf, ctypes.c_uint8), n,
                                        _ptr(out, ctypes.c_int32))
        if wrote < 0:
            return None
        return out[:wrote]

    def encode_batch(self, pieces):
        """Many pieces in one call → a list of int32 id arrays, or None on
        a byte sequence without a rank."""
        flat, counts = self.encode_flat(pieces)
        if flat is None:
            return None
        return np.split(flat, np.cumsum(counts)[:-1]) if len(counts) else []

    def encode_flat(self, pieces):
        """Many pieces in one call → (every piece's int32 ids end to end,
        the int64 id count of each piece), or (None, None) on a byte
        sequence without a rank."""
        if not pieces:
            return np.empty(0, np.int32), np.empty(0, np.int64)
        lens = np.fromiter((len(p) for p in pieces), dtype=np.int64,
                           count=len(pieces))
        offs = np.zeros(len(pieces) + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        data = np.ascontiguousarray(
            np.frombuffer(b"".join(pieces), dtype=np.uint8)) \
            if offs[-1] else np.empty(0, dtype=np.uint8)
        out = np.empty(max(int(offs[-1]), 1), dtype=np.int32)
        counts = np.empty(len(pieces), dtype=np.int64)
        total = self._lib.dn_bpe_encode_batch(
            self._handle, _ptr(offs, ctypes.c_int64),
            _ptr(data, ctypes.c_uint8) if len(data) else _NULL_U8P,
            len(pieces), _ptr(out, ctypes.c_int32),
            _ptr(counts, ctypes.c_int64))
        if total < 0:
            return None, None
        return out[:total], counts

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.dn_bpe_free(self._handle)
            self._handle = None
