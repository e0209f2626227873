"""Device-resident jet cache and the plain-torch universal screen.

Counterpart of ``pde_engine_tpu/parallel/incremental.py``.  Every unique
expression's screen-order jets and snapped order-1 fingerprint jets live
in two float32 tensors on one device (row == uid); a depth-d candidate
``op(a, b)`` is screened from its operands' rows.  :func:`universal_ref`
is the plain-torch twin of the JAX ``make_universal_kernel_raw`` over
mixed per-row ops: the reference every hand-written CUDA kernel is held
against, and the screen the engine runs when its device is the CPU.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.jetops import BINARY_NAMES, UNARY_NAMES, apply_surface_op
from ..ops.jets import n_coeffs

from ..ops.torch_xp import txp
from .search import (_RESIDUALS, pack_screen_result_compact, snap_fp_jets,
                     verdicts_from_jets)

# Fixed op numbering shared by every kernel's per-tile op id.
OP_ORDER: Tuple[str, ...] = tuple(UNARY_NAMES) + tuple(BINARY_NAMES)
OP_INDEX = {n: i for i, n in enumerate(OP_ORDER)}


class JetCache:
    """Append-only device cache of unique-expression jets.

    Row i holds the jets of the unique with uid == i.  Grows in
    ``grow_quantum`` steps, never past ``row_limit`` (rounded up to the
    quantum) when one is set.

    On one device the rows are two tensors, ``screen`` and ``fp``.  With
    a ``mesh`` (:class:`~.mesh.CandidateMesh`) they are held in one part
    per mesh device: a whole replica on each (the JAX package's replicated
    sharding), or with ``sharded`` the uid slice ``[d*C/K, (d+1)*C/K)``
    on device ``d`` (its uid-range sharding, ``SearchConfig.shard_cache``),
    the capacity ``C`` then a multiple of ``K``.  Every write reaches every
    part that holds the rows written, so a replica never misses an append
    and rows that straddle a slice boundary land in both slices.
    """

    def __init__(self, n_screen: int, t_screen: int, n_fp: int,
                 device: torch.device, initial_capacity: int = 1 << 14,
                 grow_quantum: Optional[int] = None,
                 dtype=torch.float32, mesh=None, sharded: bool = False):
        if sharded and mesh is None:
            raise ValueError("a uid-range-sharded cache needs a mesh")
        self.sdim = n_screen * t_screen
        self.fdim = n_fp * 3
        self.n = 0
        self.dtype = dtype
        self.sharded = bool(sharded)
        self.devices = (tuple(mesh.devices) if mesh is not None
                        else (torch.device(device),))
        self.device = self.devices[0]
        rq = len(self.devices) if self.sharded else 1
        self._row_quantum = rq
        self.capacity = -(-int(initial_capacity) // rq) * rq
        self.row_limit: Optional[int] = None
        self.grow_quantum = -(-int(grow_quantum or 4 * initial_capacity)
                              // rq) * rq
        self._screen, self._fp = self._alloc(self.capacity)

    def _alloc(self, capacity: int):
        rows = capacity // self._row_quantum
        return ([torch.zeros((rows, self.sdim), dtype=self.dtype, device=d)
                 for d in self.devices],
                [torch.zeros((rows, self.fdim), dtype=self.dtype, device=d)
                 for d in self.devices])

    def _whole(self, parts):
        if self.sharded:
            raise AttributeError("a uid-range-sharded cache has no single "
                                 "tensor of rows: use parts()")
        return parts[0]

    @property
    def screen(self) -> torch.Tensor:
        """Screen-jet rows (on one device, or the home replica)."""
        return self._whole(self._screen)

    @property
    def fp(self) -> torch.Tensor:
        return self._whole(self._fp)

    def parts(self):
        """``[(screen, fp, first uid)]``, one per mesh device: a whole
        replica at uid 0, or a uid slice."""
        step = self.capacity // self._row_quantum if self.sharded else 0
        return [(s, f, d * step)
                for d, (s, f) in enumerate(zip(self._screen, self._fp))]

    @classmethod
    def from_jax_snapshot(cls, snapshot, device: torch.device,
                          n_screen: int, t_screen: int, n_fp: int,
                          **kw) -> "JetCache":
        """Load the JAX package's ``JetCache.snapshot()`` dict (or a
        ``.jets.npz`` sidecar path / ``np.load`` result) bit for bit."""
        if isinstance(snapshot, str):
            with np.load(snapshot) as z:
                snapshot = {k: z[k] for k in z.files}
        screen = np.asarray(snapshot["screen"], np.float32)
        fp = np.asarray(snapshot["fp"], np.float32)
        n = int(snapshot["n"]) if "n" in snapshot else screen.shape[0]
        cache = cls(n_screen, t_screen, n_fp, device,
                    initial_capacity=max(n, kw.pop("initial_capacity",
                                                   1 << 14)), **kw)
        cache.load_rows(screen[:n], fp[:n])
        return cache

    def _grow(self, need: int):
        q = self.grow_quantum
        cap_need = -(-need // q) * q
        new_cap = max(self.capacity * 2, cap_need)
        if self.row_limit is not None:
            new_cap = max(cap_need, min(new_cap, -(-self.row_limit // q) * q))
        new_cap = -(-new_cap // self._row_quantum) * self._row_quantum
        if not self.sharded:
            pad = new_cap - self.capacity
            self._screen = [torch.cat([s, s.new_zeros((pad, self.sdim))])
                            for s in self._screen]
            self._fp = [torch.cat([f, f.new_zeros((pad, self.fdim))])
                        for f in self._fp]
            self.capacity = new_cap
            return
        # a new capacity moves every slice boundary: copy the live rows
        # into the new slices (rare: growth moves in big quanta)
        live = self.n
        old = self.parts()
        self._screen, self._fp = self._alloc(new_cap)
        self.capacity = new_cap
        step = new_cap // self._row_quantum
        for d, (s, f, lo) in enumerate(self.parts()):
            hi = min(lo + step, live)
            if lo < hi:
                rs, rf = self._read_parts(old, lo, hi, s.device)
                s[:hi - lo] = rs
                f[:hi - lo] = rf

    @staticmethod
    def _read_parts(parts, lo: int, hi: int, device):
        """Rows ``[lo, hi)`` gathered from ``parts`` onto ``device``."""
        ps, pf = [], []
        for s, f, plo in parts:
            a, b = max(lo, plo), min(hi, plo + s.shape[0])
            if a < b:
                ps.append(s[a - plo:b - plo].to(device))
                pf.append(f[a - plo:b - plo].to(device))
                if a == lo and b == hi:
                    break       # one part (a whole replica) holds them all
        return torch.cat(ps), torch.cat(pf)

    def _write(self, lo: int, rows_s: torch.Tensor, rows_f: torch.Tensor):
        """Rows ``rows_*`` at uids ``[lo, lo + k)`` of every part holding
        them."""
        hi = lo + int(rows_s.shape[0])
        for s, f, plo in self.parts():
            a, b = max(lo, plo), min(hi, plo + s.shape[0])
            if a < b:
                s[a - plo:b - plo] = rows_s[a - lo:b - lo].to(
                    s.device, self.dtype)
                f[a - plo:b - plo] = rows_f[a - lo:b - lo].to(
                    f.device, self.dtype)

    def scatter(self, uids, out_s: torch.Tensor, out_f: torch.Tensor):
        """Row ``i`` of ``out_*`` at uid ``uids[i]`` (any order), in every
        part holding that uid."""
        uids = torch.as_tensor(np.asarray(uids, np.int64))
        k = int(uids.shape[0])
        for s, f, plo in self.parts():
            mine = (uids >= plo) & (uids < plo + s.shape[0])
            sel = torch.nonzero(mine).flatten()
            if sel.numel() == 0:
                continue
            at = (uids[sel] - plo).to(s.device)
            s[at] = out_s[:k][sel.to(out_s.device)].to(s.device, self.dtype)
            f[at] = out_f[:k][sel.to(out_f.device)].to(f.device, self.dtype)

    def append(self, screen_rows: torch.Tensor, fp_rows: torch.Tensor,
               real_rows: Optional[int] = None) -> None:
        """Append rows at the tail; ``real_rows`` advances the logical size
        by less than the physical write."""
        k = int(screen_rows.shape[0])
        adv = k if real_rows is None else real_rows
        if adv == 0:
            return
        if self.n + k > self.capacity:
            self._grow(self.n + k)
        self._write(self.n, screen_rows, fp_rows)
        self.n += adv

    def append_gathered(self, out_s: torch.Tensor, out_f: torch.Tensor,
                        idx: torch.Tensor) -> None:
        """Select rows ``idx`` of a screened batch and append them at the
        tail (the JAX package's fused select + append kernel, as torch
        indexing)."""
        k = int(idx.shape[0])
        if k == 0:
            return
        if self.n + k > self.capacity:
            self._grow(self.n + k)
        self._write(self.n, out_s[idx], out_f[idx])
        self.n += k

    def load_rows(self, screen_np: np.ndarray, fp_np: np.ndarray) -> None:
        """Place host rows at [0, k) and set the logical size to k."""
        k = int(screen_np.shape[0])
        if k == 0:
            return
        if k > self.capacity:
            self._grow(k)
        self._write(0, torch.tensor(np.asarray(screen_np, np.float32)),
                    torch.tensor(np.asarray(fp_np, np.float32)))
        self.n = k

    def snapshot(self) -> dict:
        """Host copy of the live rows, in the JAX package's format."""
        out = self.snapshot_range(0, self.n)
        out["n"] = self.n
        return out

    def snapshot_range(self, lo: int, hi: int) -> dict:
        hi = min(hi, self.n)
        if hi <= lo:
            return {"screen": np.zeros((0, self.sdim), np.float32),
                    "fp": np.zeros((0, self.fdim), np.float32)}
        s, f = self._read_parts(self.parts(), lo, hi, torch.device("cpu"))
        return {"screen": s.numpy(), "fp": f.numpy()}


def universal_ref(order: int, residual_key: str, screen_rtol: float,
                  n_screen: int, n_fp: int, cache_s: torch.Tensor,
                  cache_f: torch.Tensor, ab_idx: torch.Tensor,
                  op_ids: torch.Tensor, spoints: torch.Tensor,
                  fpoints: torch.Tensor = None):
    """Plain-torch screen of candidates ``op_ids[i](cache[ab[i,0]],
    cache[ab[i,1]])`` with one op id per row.  Returns the compact packing
    ``[n, 3]`` (int32 bit patterns), screen jets ``[n, P*T]`` and snapped
    fingerprint jets ``[n, 3F]``.  Out-of-range rows clamp, as an XLA
    gather does; unary ops ignore ``b``."""
    residual_fn = _RESIDUALS[residual_key]
    T = n_coeffs(order)
    P, F = n_screen, n_fp
    n = int(ab_idx.shape[0])
    cap = int(cache_s.shape[0])
    a = ab_idx[:, 0].to(torch.int64).clamp(0, cap - 1)
    b = ab_idx[:, 1].to(torch.int64).clamp(0, cap - 1)
    out_s = cache_s.new_empty((n, P, T))
    out_f = cache_f.new_empty((n, F, 3))
    op_ids = op_ids.to(torch.int64)
    for op in torch.unique(op_ids).tolist():
        rows = torch.nonzero(op_ids == op).flatten()
        name = OP_ORDER[op]
        ra, rb = a[rows], b[rows]
        unary = name in UNARY_NAMES
        out_s[rows] = apply_surface_op(
            name, cache_s[ra].reshape(-1, P, T),
            None if unary else cache_s[rb].reshape(-1, P, T), order, txp)
        out_f[rows] = apply_surface_op(
            name, cache_f[ra].reshape(-1, F, 3),
            None if unary else cache_f[rb].reshape(-1, F, 3), 1, txp)
    out_f = snap_fp_jets(out_f)
    sr = verdicts_from_jets(out_s, out_f, spoints.to(torch.float32),
                            residual_fn, screen_rtol)
    return (pack_screen_result_compact(sr), out_s.reshape(n, -1),
            out_f.reshape(n, -1))


# ---------------------------------------------------------------------------
# The mesh calls: one hand ``universal`` launch per shard
# ---------------------------------------------------------------------------

def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    return t if t.device == device else t.to(device)


def _spec(order, residual_key, screen_rtol, n_screen, n_fp):
    from .cuda_engine import ScreenSpec
    return ScreenSpec(order, residual_key, float(screen_rtol), n_screen,
                      n_fp)


def _gathered(home: torch.device, spec, outs):
    """The shards' ``(packed, jets, fj)`` concatenated in shard order on
    ``home``, and the survivor count (bit 0 of packed column 2) summed
    over the shards: the JAX kernels' ``psum``."""
    if not outs:
        return (torch.empty((0, 3), dtype=torch.int32, device=home),
                torch.empty((0, spec.sdim), device=home),
                torch.empty((0, spec.fdim), device=home),
                torch.zeros((), dtype=torch.int64, device=home))
    n_pass = sum(_to((p[:, 2] & 1).sum(), home) for p, _, _ in outs)
    return (*(torch.cat([_to(o[i], home) for o in outs]) for i in range(3)),
            n_pass)


def make_op_kernel_sharded(mesh, op_name: str, order: int,
                           residual_key: str, screen_rtol: float,
                           n_screen: int, n_fp: int):
    """The replicated-cache mesh call (JAX ``make_op_kernel_sharded``):
    ``call(cache, ab_idx, spoints, fpoints) -> (packed, jets, fj,
    survivors)``.  The batch ``ab_idx`` (int32 ``[n, 2]``, any device) is
    split into the mesh's contiguous shards; shard ``k`` is one
    ``cuda_engine.universal`` launch on ``mesh.devices[k]`` over that
    device's replica of ``cache``.  The shards launch exactly their rows
    (an empty shard launches nothing) and their outputs come back in
    shard order on the mesh's home device."""
    from .cuda_engine import universal
    spec = _spec(order, residual_key, screen_rtol, n_screen, n_fp)
    op_id = OP_INDEX[op_name]

    def call(cache, ab_idx, spoints, fpoints):
        if cache.sharded:
            raise ValueError("the replicated mesh call needs a replicated "
                             "cache")
        outs = []
        for (lo, hi), (s, f, _) in zip(mesh.split(int(ab_idx.shape[0])),
                                       cache.parts()):
            if lo < hi:
                dev = s.device
                outs.append(universal(spec, s, f, _to(ab_idx[lo:hi], dev),
                                      op_id, _to(spoints, dev),
                                      _to(fpoints, dev)))
        return _gathered(mesh.home, spec, outs)

    return call


def pick_rows(parts, uids: torch.Tensor, device: torch.device):
    """The cache rows of ``uids`` rebuilt on ``device`` from a
    uid-range-sharded cache's ``parts``: each slice picks the rows it
    owns (clamped gather, masked as the JAX ``pick``) and they are
    combined by selection, so that every row equals the cache's bit for
    bit, signed zeros included (the JAX ``psum`` turns a -0.0 into
    +0.0).  A uid no slice owns gives a zero row."""
    sdim, fdim = parts[0][0].shape[1], parts[0][1].shape[1]
    n = int(uids.shape[0])
    out_s = torch.zeros((n, sdim), dtype=parts[0][0].dtype, device=device)
    out_f = torch.zeros((n, fdim), dtype=parts[0][1].dtype, device=device)
    for s, f, lo in parts:
        rows = int(s.shape[0])
        rel = _to(uids, s.device).to(torch.int64) - lo
        ok = _to((rel >= 0) & (rel < rows), device)[:, None]
        rel = rel.clamp(0, rows - 1)
        out_s = torch.where(ok, _to(s[rel], device), out_s)
        out_f = torch.where(ok, _to(f[rel], device), out_f)
    return out_s, out_f


def make_op_kernel_uidrange(mesh, op_name: str, order: int,
                            residual_key: str, screen_rtol: float,
                            n_screen: int, n_fp: int):
    """The uid-range-sharded mesh call (JAX
    ``make_op_kernel_uidrange``): the cache is split by uid range over
    the mesh (``JetCache(sharded=True)``).  For shard ``k`` of the batch
    the operand rows ``a`` then ``b`` are rebuilt on ``mesh.devices[k]``
    (:func:`pick_rows`), and ``universal`` runs on them with the
    identity indices ``(i, i + m)``, as the JAX ``_apply_raw_on_rows``
    does.  The JAX call needs the batch and the cache to be multiples of
    the mesh size; here shards are any size, and the cache's capacity is
    a multiple of it by construction."""
    from .cuda_engine import universal
    spec = _spec(order, residual_key, screen_rtol, n_screen, n_fp)
    op_id = OP_INDEX[op_name]

    def call(cache, ab_idx, spoints, fpoints):
        if not cache.sharded:
            raise ValueError("the uid-range mesh call needs a "
                             "uid-range-sharded cache")
        parts = cache.parts()
        outs = []
        for k, (lo, hi) in enumerate(mesh.split(int(ab_idx.shape[0]))):
            if lo == hi:
                continue
            dev, m = mesh.devices[k], hi - lo
            uids = ab_idx[lo:hi].t().reshape(-1)      # a rows, then b rows
            rows_s, rows_f = pick_rows(parts, uids, dev)
            ident = torch.arange(m, dtype=torch.int32, device=dev)
            ab = torch.stack([ident, ident + m], dim=1)
            outs.append(universal(spec, rows_s, rows_f, ab, op_id,
                                  _to(spoints, dev), _to(fpoints, dev)))
        return _gathered(mesh.home, spec, outs)

    return call
