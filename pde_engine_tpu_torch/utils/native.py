"""ctypes binding for the native host-ingest core (csrc/ingest_core.cpp).

Copy of ``pde_engine_tpu/utils/native.py`` over the port's own copy of the
C++ source (``pde_engine_tpu_torch/csrc/ingest_core.cpp``).  The core is
compiled with g++ at first use and cached where the screen kernels build
(``cuda_build.build_root``: the checkout's ``build/torch_ext/``, or the
user cache directory of an installed package), keyed by a source digest —
no pip, no pybind11 (not in the image).  Everything here degrades
gracefully: if the compiler or libsqlite3 is missing, callers get
``None`` from :func:`load_core` and fall back to the pure-Python paths
(pipeline keeps a dict dedup map and tuple-based row emission), so the
package works on any host while the native core doubles ingest throughput on
the production path.

The reference's analogous component is its host-side record keeping — the
emit_to_db hot loop + writer process (general_method_paper_reproduction.py:
1251-1411, 1109-1220), which were pure Python over queues.
"""

from __future__ import annotations

import ctypes as ct
import glob
import hashlib
import os
import queue
import subprocess
import sys
import threading
from typing import Optional, Tuple

import numpy as np

from . import spans

_lock = threading.Lock()
_core = None
_core_tried = False


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _find_sqlite_lib() -> Optional[str]:
    cands = []
    for pat in ("/lib/*/libsqlite3.so*", "/usr/lib/*/libsqlite3.so*",
                "/usr/lib/libsqlite3.so*", "/usr/local/lib/libsqlite3.so*"):
        cands += glob.glob(pat)
    if cands:
        return sorted(cands)[0]
    try:
        out = subprocess.run(["ldconfig", "-p"], capture_output=True,
                             text=True, timeout=10).stdout
        for line in out.splitlines():
            if "libsqlite3.so" in line and "=>" in line:
                return line.split("=>")[-1].strip()
    except Exception:
        pass
    return None


def _build(src: str, out_so: str) -> bool:
    sqlite = _find_sqlite_lib()
    if sqlite is None:
        return False
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src,
           "-o", out_so, sqlite]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if r.returncode != 0:
        sys.stderr.write(f"[native] build failed:\n{r.stderr[:2000]}\n")
        return False
    return True


def load_core() -> Optional[ct.CDLL]:
    """Load (building if needed) the native core; None when unavailable."""
    global _core, _core_tried
    with _lock:
        if _core_tried:
            return _core
        _core_tried = True
        if os.environ.get("PDE_ENGINE_NO_NATIVE"):
            return None
        # the port's own copy of the source, built into <build
        # root>/<digest>/ beside the screen kernels (cuda_build.build_root:
        # the checkout's build/torch_ext, else the user cache directory)
        src = os.path.join(_package_root(), "csrc", "ingest_core.cpp")
        if not os.path.exists(src):
            return None
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        from .cuda_build import build_root
        build_dir = os.path.join(build_root(), digest)
        os.makedirs(build_dir, exist_ok=True)
        so = os.path.join(build_dir, "libpde_ingest.so")
        if not os.path.exists(so):
            tmp = so + f".tmp{os.getpid()}"
            if not _build(src, tmp):
                return None
            os.replace(tmp, so)
        try:
            lib = ct.CDLL(so)
        except OSError:
            return None
        _declare(lib)
        _core = lib
        return _core


def _declare(lib: ct.CDLL):
    u64p = ct.POINTER(ct.c_uint64)
    i64p = ct.POINTER(ct.c_int64)
    lib.dm_new.restype = ct.c_void_p
    lib.dm_new.argtypes = [ct.c_uint64]
    lib.dm_free.argtypes = [ct.c_void_p]
    lib.dm_size.restype = ct.c_int64
    lib.dm_size.argtypes = [ct.c_void_p]
    lib.dm_insert_batch.restype = ct.c_int64
    lib.dm_insert_batch.argtypes = [ct.c_void_p, u64p, ct.c_int64,
                                    ct.c_int64, i64p]
    lib.dm_get.restype = ct.c_int64
    lib.dm_get.argtypes = [ct.c_void_p, ct.c_uint64]
    lib.dm_set.argtypes = [ct.c_void_p, ct.c_uint64, ct.c_int64]
    lib.dm_items.argtypes = [ct.c_void_p, u64p, i64p]
    lib.dm_set_batch.argtypes = [ct.c_void_p, u64p, i64p, ct.c_int64]
    lib.idb_open.restype = ct.c_void_p
    lib.idb_open.argtypes = [ct.c_char_p, ct.c_char_p]
    lib.idb_error.restype = ct.c_char_p
    lib.idb_error.argtypes = [ct.c_void_p]
    lib.idb_close.argtypes = [ct.c_void_p]
    i32p = ct.POINTER(ct.c_int32)
    lib.idb_emit_rejects.restype = ct.c_int64
    lib.idb_emit_rejects.argtypes = [
        ct.c_void_p, ct.c_int64, i64p, ct.c_char_p, u64p, ct.c_int32,
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_float),
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8),
        ct.POINTER(ct.c_uint8), ct.POINTER(ct.c_uint8),
        ct.c_int32, ct.c_char_p, ct.c_int32, i32p, i32p]
    lib.ea_new.restype = ct.c_void_p
    lib.ea_new.argtypes = []
    lib.ea_new_spill.restype = ct.c_void_p
    lib.ea_new_spill.argtypes = [ct.c_char_p]
    lib.ea_free.argtypes = [ct.c_void_p]
    lib.ea_count.restype = ct.c_int64
    lib.ea_count.argtypes = [ct.c_void_p]
    lib.ea_bytes.restype = ct.c_int64
    lib.ea_bytes.argtypes = [ct.c_void_p]
    lib.ea_add_raw.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_int64]
    lib.ea_add_bulk.restype = ct.c_int64
    lib.ea_add_bulk.argtypes = [ct.c_void_p, ct.c_char_p, ct.c_char_p,
                                ct.c_char_p, i32p, i32p, ct.c_int64,
                                ct.c_int32]
    lib.ea_set_wrapped.restype = ct.c_int64
    lib.ea_set_wrapped.argtypes = [ct.c_void_p, ct.c_int64, ct.c_char_p]
    lib.ea_strlen.restype = ct.c_int32
    lib.ea_strlen.argtypes = [ct.c_void_p, ct.c_int64]
    lib.ea_get.restype = ct.c_int32
    lib.ea_get.argtypes = [ct.c_void_p, ct.c_int64, ct.c_char_p,
                           ct.c_int32]
    lib.ea_blob_size.restype = ct.c_int64
    lib.ea_blob_size.argtypes = [ct.c_void_p, i64p, ct.c_int64]
    lib.ea_blob.argtypes = [ct.c_void_p, i64p, ct.c_int64, ct.c_char_p]
    lib.ea_truncate.argtypes = [ct.c_void_p, ct.c_int64]
    f64p = ct.POINTER(ct.c_double)
    lib.ej_eval_many.restype = ct.c_int64
    lib.ej_eval_many.argtypes = [i32p, i64p, ct.c_int64, ct.c_int64,
                                 f64p, f64p, ct.c_int64, ct.c_int32,
                                 f64p]
    i16p = ct.POINTER(ct.c_int16)
    lib.tm_build_batch.restype = ct.c_int64
    lib.tm_build_batch.argtypes = [i16p, i32p, i32p, i32p, i64p, i64p,
                                   ct.c_int64, ct.c_int32, i64p,
                                   ct.c_int64, i32p, ct.c_int64, i64p]


def _as_ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ct.POINTER(ctype))


def hugepage_array(n: int, dtype, fill) -> np.ndarray:
    """A 1-D numpy array backed by a 2 MiB-aligned anonymous mmap advised
    MADV_HUGEPAGE, pre-faulted by the fill pass.

    Same trick as csrc's arena_alloc, in pure Python, for the registry's
    SoA growth: on the slow-fault virtualized build hosts every fresh
    4 KiB anonymous page costs 30 µs–3 ms in a hypervisor exit, so a
    plain np.concatenate doubling of a ~700 MB registry burns tens of
    seconds in faults alone (measured: 43 s of a laplace depth-6
    register stage).  2 MiB pages cut the fault count 512×.  Falls back
    to np.full when mmap.madvise/MADV_HUGEPAGE is unavailable.

    Overhead note: each array maps nbytes + 2 MiB and
    the leading alignment slack is never trimmed, so a registry of eight
    SoA arrays wastes ~16 MiB per growth generation until the superseded
    mmaps are garbage-collected — noise against the multi-GB arrays this
    is used for, and the old generation is dropped by the caller right
    after the copy anyway."""
    import mmap as _mmap

    dt = np.dtype(dtype)
    nbytes = int(n) * dt.itemsize
    try:
        align = 1 << 21
        mm = _mmap.mmap(-1, nbytes + align)
        addr = ct.addressof(ct.c_char.from_buffer(mm))
        off = (-addr) % align
        mm.madvise(_mmap.MADV_HUGEPAGE, off, nbytes)
        arr = np.frombuffer(mm, dtype=dt, count=int(n), offset=off)
        arr.flags.writeable = True
    except (AttributeError, ValueError, OSError):
        return np.full(int(n), fill, dtype=dt)
    arr.fill(fill)          # sequential pre-fault on huge pages
    return arr


class DedupMap:
    """uint64 -> uid map with dict-compatible surface.

    Backed by the native open-addressing map when the core is available,
    else by a plain dict.  ``insert_batch`` is the hot call: first
    occurrences of absent keys get consecutive uids in batch order
    (identical semantics to the np.unique + dict filter in
    an earlier pipeline._ingest_vec).
    """

    def __init__(self, core: Optional[ct.CDLL] = None,
                 cap_hint: int = 1 << 16, force_python: bool = False):
        self._core = None if force_python else (
            core if core is not None else load_core())
        if self._core is not None:
            self._h = self._core.dm_new(ct.c_uint64(cap_hint))
            self._d = None
        else:
            self._h = None
            self._d = {}

    @property
    def native(self) -> bool:
        return self._d is None

    def insert_batch(self, keys: np.ndarray, base_uid: int) -> np.ndarray:
        """Insert ``keys`` (uint64); absent keys get uids base_uid+0.. in
        first-occurrence order.  Returns the batch positions of new keys."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys.size
        if self._d is not None:
            # vectorized within-batch dedup, then filter vs the dict —
            # the same shape as the original Python hot path
            _, first_idx = np.unique(keys, return_index=True)
            first_idx.sort()
            d = self._d
            out = []
            nb = base_uid
            for i in first_idx.tolist():
                k = int(keys[i])
                if k not in d:
                    d[k] = nb
                    nb += 1
                    out.append(i)
            return np.asarray(out, dtype=np.int64)
        out = np.empty(n, dtype=np.int64)
        n_new = self._core.dm_insert_batch(
            self._h, _as_ptr(keys, ct.c_uint64), ct.c_int64(n),
            ct.c_int64(base_uid), _as_ptr(out, ct.c_int64))
        return out[:n_new]

    def __contains__(self, key: int) -> bool:
        if self._d is not None:
            return key in self._d
        return self._core.dm_get(self._h, ct.c_uint64(key)) >= 0

    def __setitem__(self, key: int, val: int):
        if self._d is not None:
            self._d[key] = val
        else:
            self._core.dm_set(self._h, ct.c_uint64(key), ct.c_int64(val))

    def set_batch(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Bulk exact assignment (resume rebuilds key -> uid)."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.int64)
        if self._d is not None:
            self._d.update(zip(keys.tolist(), vals.tolist()))
        else:
            self._core.dm_set_batch(self._h, _as_ptr(keys, ct.c_uint64),
                                    _as_ptr(vals, ct.c_int64),
                                    ct.c_int64(keys.size))

    def __getitem__(self, key: int) -> int:
        if self._d is not None:
            return self._d[key]
        v = self._core.dm_get(self._h, ct.c_uint64(key))
        if v < 0:
            raise KeyError(key)
        return int(v)

    def get(self, key: int, default=None):
        if self._d is not None:
            return self._d.get(key, default)
        v = self._core.dm_get(self._h, ct.c_uint64(key))
        return default if v < 0 else int(v)

    def __len__(self) -> int:
        if self._d is not None:
            return len(self._d)
        return int(self._core.dm_size(self._h))

    def items(self):
        ks, vs = self.items_arrays()
        return list(zip(ks.tolist(), vs.tolist()))

    def items_arrays(self):
        """(keys, uids) as numpy arrays — the registry-sidecar export
        (runtime._save_registry_sidecar scatters keys into uid order)."""
        if self._d is not None:
            n = len(self._d)
            ks = np.fromiter(self._d.keys(), dtype=np.uint64, count=n)
            vs = np.fromiter(self._d.values(), dtype=np.int64, count=n)
            return ks, vs
        n = len(self)
        ks = np.empty(n, dtype=np.uint64)
        vs = np.empty(n, dtype=np.int64)
        if n:
            self._core.dm_items(self._h, _as_ptr(ks, ct.c_uint64),
                                _as_ptr(vs, ct.c_int64))
        return ks, vs

    def __del__(self):
        core, h = getattr(self, "_core", None), getattr(self, "_h", None)
        if core is not None and h is not None:
            try:
                core.dm_free(h)
            except Exception:
                pass


def eval_jets_native(tapes: np.ndarray, lengths: np.ndarray,
                     consts: np.ndarray, points: np.ndarray,
                     order: int) -> Optional[np.ndarray]:
    """C float64 jet-tape oracle (csrc ej_eval_many) — same math and
    operation order as ops/interpreter.eval_jets_np_many.  Returns None
    when the native core is unavailable or the call is unsupported
    (order > 4, unknown opcode) so callers fall back to NumPy."""
    core = load_core()
    if core is None or order > 4:
        return None
    tapes = np.ascontiguousarray(tapes, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    consts = np.ascontiguousarray(consts, dtype=np.float64)
    # bounds guard: a CONST row indexing past the consts snapshot would
    # be a SILENT out-of-bounds read in C (zeros, not a crash — bug class:
    # parse() interns new constants, so a consts array
    # snapshot taken before parsing can be stale)
    from ..ops.optable import CONST
    cmask = tapes[:, :, 0] == CONST
    if cmask.any() and int(tapes[:, :, 2][cmask].max()) >= consts.size:
        raise IndexError(
            f"tape CONST index {int(tapes[:, :, 2][cmask].max())} out of "
            f"bounds for consts table of size {consts.size} — snapshot "
            "problem.consts AFTER parsing/composing the tapes")
    points = np.ascontiguousarray(points, dtype=np.float64)
    n, L, _ = tapes.shape
    P = points.shape[0]
    T = (order + 1) * (order + 2) // 2
    out = np.empty((n, P, T), dtype=np.float64)
    with np.errstate(all="ignore"):
        r = core.ej_eval_many(
            _as_ptr(tapes, ct.c_int32), _as_ptr(lengths, ct.c_int64),
            ct.c_int64(n), ct.c_int64(L), _as_ptr(consts, ct.c_double),
            _as_ptr(points, ct.c_double), ct.c_int64(P),
            ct.c_int32(order), _as_ptr(out, ct.c_double))
    return out if r == 0 else None


class TapeBuilder:
    """Native tape materializer: flatten registry uids into SSA tapes in
    C (csrc tm_build_batch — byte-identical to the Python composition,
    asserted in tests/test_native.py).  Removes the ~100-150 µs/passer
    ancestor-materialization cost (PERF roadmap #3)."""

    # ALL_SURFACE_OPS insertion order the C enum hard-codes
    _EXPECTED_OPS = ("neg", "inv", "sqrt", "square", "pow_3_2",
                     "pow_neg_3_2", "exp", "exp_neg", "add", "sub", "mul",
                     "div", "geom_sum", "sqrt_shift_neg", "sqrt_shift_pos",
                     "exp_mul", "log_mul")

    def __init__(self, op_names, leaf_tapes, one_idx: int,
                 core: Optional[ct.CDLL] = None):
        """``op_names``: the enumerator's surface-op id order;
        ``leaf_tapes``: depth-1 tapes indexed by uid (the uid prefix);
        ``one_idx``: const-table index of Fraction(1)."""
        self._core = core if core is not None else load_core()
        if self._core is None:
            raise RuntimeError("native core unavailable")
        if tuple(op_names) != self._EXPECTED_OPS:
            raise RuntimeError("surface-op order mismatch vs C enum")
        self._one_idx = int(one_idx)
        lens = [len(t) for t in leaf_tapes]
        self._leaf_len = np.array(lens, dtype=np.int64)
        self._leaf_off = np.concatenate(
            ([0], np.cumsum(self._leaf_len[:-1]))).astype(np.int64) \
            if lens else np.zeros(0, np.int64)
        self._leaf_rows = (np.concatenate(
            [np.asarray(t.rows, np.int32) for t in leaf_tapes])
            if lens else np.zeros((0, 3), np.int32))
        self._leaf_rows = np.ascontiguousarray(self._leaf_rows, np.int32)
        self._n_leaves = len(lens)

    def build_batch(self, u_op: np.ndarray, u_a: np.ndarray,
                    u_b: np.ndarray, uids: np.ndarray,
                    max_len: int) -> Optional[Tuple[np.ndarray,
                                                    np.ndarray]]:
        """(padded_tapes [n, max_len, 3], lengths [n]) or None when a
        tape exceeds max_len (caller retries bigger / falls back)."""
        uids = np.ascontiguousarray(uids, dtype=np.int64)
        n = uids.size
        out = np.zeros((n, max_len, 3), dtype=np.int32)
        lens = np.empty(n, dtype=np.int64)
        u_op = np.ascontiguousarray(u_op, np.int16)
        u_a = np.ascontiguousarray(u_a, np.int32)
        u_b = np.ascontiguousarray(u_b, np.int32)
        r = self._core.tm_build_batch(
            _as_ptr(u_op, ct.c_int16), _as_ptr(u_a, ct.c_int32),
            _as_ptr(u_b, ct.c_int32),
            _as_ptr(self._leaf_rows, ct.c_int32),
            _as_ptr(self._leaf_off, ct.c_int64),
            _as_ptr(self._leaf_len, ct.c_int64),
            ct.c_int64(self._n_leaves), ct.c_int32(self._one_idx),
            _as_ptr(uids, ct.c_int64), ct.c_int64(n),
            _as_ptr(out, ct.c_int32), ct.c_int64(max_len),
            _as_ptr(lens, ct.c_int64))
        if r != 0:
            return None
        return out, lens


class ExprArena:
    """Native display-string store: one growable byte buffer + per-uid
    (offset, length).  Children are composed from parent bytes in C
    (ea_add_bulk), and the reject sink's NUL-separated blob is packed
    with one memcpy pass (ea_blob) — replacing ~100 s of per-unique
    Python string work on a 24M-unique depth-5 run.  ``None`` handle ⇒
    caller should use the Python list path."""

    def __init__(self, core: Optional[ct.CDLL] = None,
                 spill_dir: Optional[str] = None):
        """``spill_dir``: back the byte buffer with an UNLINKED temp
        file there (MAP_SHARED) so string pages are evictable under
        memory pressure — lifts the ~50 B/unique display-string share
        of the single-host registry RAM ceiling (PERF.md roadmap).
        Falls back to the anonymous arena when the directory rejects
        temp files; check ``spilled``."""
        self._core = core if core is not None else load_core()
        if self._core is None:
            raise RuntimeError("native core unavailable")
        self.spilled = False
        self._h = None
        if spill_dir is not None:
            h = self._core.ea_new_spill(spill_dir.encode())
            if h:
                self._h = h
                self.spilled = True
        if self._h is None:
            self._h = self._core.ea_new()

    def __len__(self) -> int:
        return int(self._core.ea_count(self._h))

    @property
    def nbytes(self) -> int:
        return int(self._core.ea_bytes(self._h))

    def add_raw(self, strings) -> None:
        blob = "\x00".join(strings).encode() + b"\x00"
        self._core.ea_add_raw(self._h, blob, ct.c_int64(len(strings)))

    def set_wrapped(self, uid: int, wrapped: str) -> None:
        """Wrapped-form override (composite primitives only)."""
        if self._core.ea_set_wrapped(self._h, ct.c_int64(uid),
                                     wrapped.encode()) < 0:
            raise RuntimeError("ea_set_wrapped: override table full")

    def add_bulk(self, p1: str, mid: Optional[str], p2: str,
                 a_uids: np.ndarray, b_uids: Optional[np.ndarray],
                 use_wrapped: bool = False) -> int:
        """Append composed strings; returns the first new uid."""
        uid0 = len(self)
        a_uids = np.ascontiguousarray(a_uids, dtype=np.int32)
        n = a_uids.size
        if b_uids is not None:
            b_uids = np.ascontiguousarray(b_uids, dtype=np.int32)
        r = self._core.ea_add_bulk(
            self._h, p1.encode(), mid.encode() if mid is not None else None,
            p2.encode(), _as_ptr(a_uids, ct.c_int32),
            _as_ptr(b_uids, ct.c_int32) if b_uids is not None else None,
            ct.c_int64(n), ct.c_int32(1 if use_wrapped else 0))
        if r < 0:
            raise ValueError("ea_add_bulk: parent uid out of range")
        return uid0

    def get(self, uid: int) -> str:
        n = self._core.ea_strlen(self._h, ct.c_int64(uid))
        if n < 0:
            raise IndexError(uid)
        buf = ct.create_string_buffer(n)
        self._core.ea_get(self._h, ct.c_int64(uid), buf, n)
        return buf.raw.decode()

    def blob(self, uids: np.ndarray) -> bytes:
        """NUL-separated blob of the given uids' strings (the native
        sink's expr_blob format, trailing NUL included)."""
        uids = np.ascontiguousarray(uids, dtype=np.int64)
        total = self._core.ea_blob_size(self._h, _as_ptr(uids, ct.c_int64),
                                        ct.c_int64(uids.size))
        if total < 0:
            raise IndexError("ea_blob: uid out of range")
        buf = ct.create_string_buffer(int(total))
        self._core.ea_blob(self._h, _as_ptr(uids, ct.c_int64),
                           ct.c_int64(uids.size), buf)
        return buf.raw

    def truncate(self, keep: int) -> None:
        self._core.ea_truncate(self._h, ct.c_int64(keep))

    def __del__(self):
        core, h = getattr(self, "_core", None), getattr(self, "_h", None)
        if core is not None and h is not None:
            try:
                core.ea_free(h)
            except Exception:
                pass


class NativeRejectSink:
    """Reject rows straight into the run DB via the native prepared-statement
    writer.  One call per candidate batch; its own transaction.

    Writes happen on a dedicated writer thread (the reference funneled all
    result writes through one `_db_update_writer` process, general:1109-
    1220; here one thread per run keeps the single-writer discipline):
    ctypes releases the GIL for the C call, so on one-core hosts
    the sqlite work overlaps the main thread's device waits instead
    of sitting on the depth's critical path (~6 s of a warm depth-4 run).
    """

    QUEUE_MAX = 8  # batches in flight (bounds buffered row memory)

    def __init__(self, db_path: str, table: str):
        core = load_core()
        if core is None:
            raise RuntimeError("native core unavailable")
        self._core = core
        self._h = core.idb_open(db_path.encode(), table.encode())
        err = core.idb_error(self._h)
        if err:
            msg = err.decode()
            core.idb_close(self._h)
            self._h = None
            raise RuntimeError(f"native sink: {msg}")
        self._q: "queue.Queue" = queue.Queue(maxsize=self.QUEUE_MAX)
        self._err = None
        self._writer = threading.Thread(target=self._drain, daemon=True,
                                        name="sink")
        self._writer.start()

    def _drain(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                if self._err is None:
                    self._emit_now(*item)
            except Exception as e:  # surfaced at next emit()/flush()
                self._err = e
            finally:
                self._q.task_done()

    def emit(self, ids: np.ndarray, exprs_blob: bytes, sigs: np.ndarray,
             depth: int, reason_code: np.ndarray, rel: np.ndarray,
             screen_ok: np.ndarray, nonfinite: np.ndarray,
             is_const: np.ndarray, fp_finite: np.ndarray,
             n_screen_points: int, math_def: bytes,
             struct_op: int = -1,
             struct_a: Optional[np.ndarray] = None,
             struct_b: Optional[np.ndarray] = None) -> int:
        """Queue one batch for the writer thread.  The arrays are copied
        to owned contiguous buffers here (callers may reuse/slice)."""
        if self._err is not None:
            raise self._err
        n = ids.size
        if n == 0:
            return 0
        b8 = lambda a: np.ascontiguousarray(a, dtype=np.uint8)  # noqa: E731
        i32 = lambda a: (None if a is None else  # noqa: E731
                         np.ascontiguousarray(a, dtype=np.int32).copy())
        item = (
            np.ascontiguousarray(ids, dtype=np.int64).copy(), exprs_blob,
            np.ascontiguousarray(sigs, dtype=np.uint64).copy(), depth,
            np.ascontiguousarray(reason_code, dtype=np.uint8).copy(),
            np.ascontiguousarray(rel, dtype=np.float32).copy(),
            b8(screen_ok).copy(), b8(nonfinite).copy(), b8(is_const).copy(),
            b8(fp_finite).copy(), n_screen_points, math_def,
            struct_op, i32(struct_a), i32(struct_b))
        spans.count("sink.batches")
        spans.count("sink.rows", n)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            spans.count("sink.blocked")
            with spans.span("sink.wait"):
                self._q.put(item)
        return n

    @spans.traced("sink.write")
    def _emit_now(self, ids, exprs_blob, sigs, depth, reason_code, rel,
                  screen_ok, nonfinite, is_const, fp_finite,
                  n_screen_points, math_def, struct_op, struct_a,
                  struct_b) -> int:
        n = ids.size
        r = self._core.idb_emit_rejects(
            self._h, ct.c_int64(n), _as_ptr(ids, ct.c_int64), exprs_blob,
            _as_ptr(sigs, ct.c_uint64), ct.c_int32(depth),
            _as_ptr(reason_code, ct.c_uint8), _as_ptr(rel, ct.c_float),
            _as_ptr(screen_ok, ct.c_uint8),
            _as_ptr(nonfinite, ct.c_uint8),
            _as_ptr(is_const, ct.c_uint8),
            _as_ptr(fp_finite, ct.c_uint8),
            ct.c_int32(n_screen_points), math_def,
            ct.c_int32(struct_op if struct_a is not None else -1),
            _as_ptr(struct_a, ct.c_int32) if struct_a is not None
            else None,
            _as_ptr(struct_b, ct.c_int32) if struct_b is not None
            else None)
        if r < 0:
            raise RuntimeError(
                "native emit failed: "
                + self._core.idb_error(self._h).decode())
        return int(r)

    def flush(self):
        """Block until every queued batch is committed (depth barriers,
        monitor counts, and close() call this)."""
        with spans.span("sink.wait"):
            self._q.join()
        if self._err is not None:
            raise self._err

    def close(self):
        if self._h is not None:
            try:
                with spans.span("sink.wait"):
                    self._q.join()
                    self._q.put(None)
                    self._writer.join(timeout=30)
            finally:
                self._core.idb_close(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
