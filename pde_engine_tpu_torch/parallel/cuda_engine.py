"""The fused screen kernels on the GPU: counterpart of
``pde_engine_tpu/parallel/pallas_engine.py``.

Four entry points with the JAX kernels' call signatures and return
tuples ``(packed [n, 3] int32 bit patterns, jets [n, P*T] f32,
fj [n, 3F] f32 snapped)``:

- :func:`segmented` — mixed ops, one op id per row (the JAX kernel's op
  id per 512-candidate tile, carried per row so that no tile is padded),
  operands by per-row ``ab_idx``, any ``n``;
- :func:`structured` — one op, one constant row and the contiguous rows
  ``[big0, big0 + n)``;
- :func:`tiled` — per 512-tile ``(opkind, start, const_uid)``;
- :func:`universal` — one op id for the whole launch, operands by per-row
  ``ab_idx``, any ``n`` (the per-op engine path and its resume replay).

On a CUDA tensor each launches its hand-written kernel
(``csrc/screen_kernel.cu``) or raises; on a CPU tensor it runs its plain
torch ``*_ref`` twin.  The choice follows the tensors' device only:
nothing catches a build or launch error and falls back.  ``LAUNCHES``
counts kernel launches per entry point.  Inside :func:`debug_nans` each
entry point synchronises after its launch and raises
``FloatingPointError`` on a NaN in its outputs (the counterpart of
``jax_debug_nans``, for kernel debugging: the screen makes NaNs on
purpose wherever an op leaves its domain).

``structured`` and ``universal`` size their blocks to the launch
(:func:`candidates_per_block`): a block's steps run one after another,
so a launch that cannot fill the card runs in fewer candidates per
block.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Dict

import torch

from ..ops import cuda_emit
from ..ops.jetops import UNARY_NAMES
from ..ops.jets import n_coeffs
from . import search
from . import incremental
from .incremental import OP_ORDER

TILE = 512
N_UNARY = sum(1 for nm in OP_ORDER if nm in UNARY_NAMES)
KERNELS = ("segmented", "structured", "tiled", "universal")
# candidates per block the group kernels take: 1, 2, 4 or 8 steps of 16
# (128 threads, 8 lanes per candidate); each divides the 512-row tile
GROUP_CANDS = (16, 32, 64, 128)

# kernel launches per entry point (read and reset by chip_smoke.py)
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_DEBUG_NANS = [False]


@contextlib.contextmanager
def debug_nans():
    """While active, every entry point checks its outputs for NaN."""
    prev = _DEBUG_NANS[0]
    _DEBUG_NANS[0] = True
    try:
        yield
    finally:
        _DEBUG_NANS[0] = prev


def _nan_checked(kernel: str, out, op_of_row):
    """``out`` unchanged; inside :func:`debug_nans`, first synchronise and
    raise ``FloatingPointError`` naming the kernel, the op and the first
    row whose screen jets, fingerprint jets or packed relative residual
    hold a NaN.  ``op_of_row(i)`` is row ``i``'s op id."""
    if not _DEBUG_NANS[0]:
        return out
    packed, jets, fj = out
    if jets.device.type == "cuda":
        torch.cuda.synchronize(jets.device)
    rel = (packed[:, 2] & -65536).view(torch.float32)
    bad = torch.isnan(jets).any(1) | torch.isnan(fj).any(1) | torch.isnan(rel)
    if bool(bad.any()):
        row = int(torch.nonzero(bad)[0, 0])
        raise FloatingPointError(
            f"{kernel}: NaN in the outputs of row {row} of "
            f"{int(bad.shape[0])} (op {OP_ORDER[int(op_of_row(row))]}, "
            f"{int(bad.sum())} rows hold one)")
    return out


def candidates_per_block(n: int, slots: int, step: int = 16) -> int:
    """Candidates per block of a ``structured`` or ``universal`` launch of
    ``n`` rows on a card that holds ``slots`` blocks at once (SMs x
    resident blocks per SM): the largest of :data:`GROUP_CANDS` (whole
    steps of ``step`` candidates) whose grid still fills the slots, else
    the smallest.  262,144 rows on an H100 (528 slots) take 128; the
    per-op path's launches of about 500 rows and structured's of 4,096
    take 16, one step per block."""
    sizes = [c for c in GROUP_CANDS if c % step == 0]
    for c in reversed(sizes):
        if -(-n // c) >= slots:
            return c
    return sizes[0]


@dataclass(frozen=True)
class ScreenSpec:
    """What the JAX kernel factories take: jet order, residual key,
    screen tolerance and point counts."""
    order: int
    residual_key: str
    screen_rtol: float
    n_screen: int
    n_fp: int

    @property
    def sdim(self) -> int:
        return self.n_screen * n_coeffs(self.order)

    @property
    def fdim(self) -> int:
        return 3 * self.n_fp


@functools.lru_cache(maxsize=None)
def header_text(spec: ScreenSpec) -> str:
    """The emitted jet algebra plus the verdict constants of
    ``parallel/search.py`` as exact float32 literals."""
    lit = cuda_emit.f32_literal
    consts = "\n".join([
        f"#define JET_N_UNARY {N_UNARY}",
        f"#define JET_TINY {lit(search.JET_TINY)}",
        f"#define JET_SCALE_FLOOR {lit(search.SCALE_FLOOR)}",
        f"#define JET_REL_EPS {lit(search.REL_EPS)}",
        f"#define JET_SENTINEL {lit(search._SENTINEL)}",
        f"#define JET_FNV_A_MULT {search.FNV_A[0]:#x}u",
        f"#define JET_FNV_A_SEED {search.FNV_A[1]:#x}u",
        f"#define JET_FNV_B_MULT {search.FNV_B[0]:#x}u",
        f"#define JET_FNV_B_SEED {search.FNV_B[1]:#x}u",
    ])
    body = cuda_emit.emit_header(spec.order, spec.residual_key,
                                 search._RESIDUALS[spec.residual_key],
                                 spec.n_screen, spec.n_fp)
    return body + "\n" + consts + "\n"


@functools.lru_cache(maxsize=None)
def _library(spec: ScreenSpec):
    import ctypes

    from ..utils.cuda_build import load_screen_library
    lib = load_screen_library(header_text(spec))
    dims = (ctypes.c_int * 4)()
    lib.pde_screen_dims(ctypes.addressof(dims))
    want = (n_coeffs(spec.order), spec.n_screen, spec.n_fp, len(OP_ORDER))
    if tuple(dims) != want:
        raise RuntimeError(f"screen library built for {tuple(dims)}, "
                           f"spec needs {want}")
    return lib


@functools.lru_cache(maxsize=None)
def geometry(spec: ScreenSpec) -> dict:
    """The kernels' launch geometry on the current card, read once from
    the library: per kernel its dynamic shared memory per block
    (``smem``) and the blocks resident on one SM at that shared memory
    (``blocks_per_sm``), the card's ``sms``, the ``lanes`` per candidate
    group and the candidates per ``step``."""
    import ctypes
    out = (ctypes.c_int * 11)()
    _raise_on(_library(spec).pde_screen_geometry(ctypes.addressof(out)),
              "geometry query")
    v = list(out)
    return {"smem": dict(zip(KERNELS, v[0:4])),
            "blocks_per_sm": dict(zip(KERNELS, v[4:8])), "sms": v[8],
            "lanes": v[9], "step": v[10]}


def block_cands(spec: ScreenSpec, kernel: str, n: int) -> int:
    """Candidates per block of a launch of ``n`` rows of ``kernel`` on
    the current card (:func:`candidates_per_block`)."""
    g = geometry(spec)
    return candidates_per_block(n, g["sms"] * g["blocks_per_sm"][kernel],
                                g["step"])


# ---------------------------------------------------------------------------
# Plain torch references
# ---------------------------------------------------------------------------

def _universal(spec, cache_s, cache_f, ab, ops, spoints, fpoints):
    return incremental.universal_ref(
        spec.order, spec.residual_key, spec.screen_rtol, spec.n_screen,
        spec.n_fp, cache_s, cache_f, ab, ops, spoints, fpoints)


def universal_ref(spec: ScreenSpec, cache_s, cache_f, ab_idx, op_id: int,
                  spoints, fpoints):
    """One op over every row of ``ab_idx`` (make_pallas_universal_kernel
    with a uniform op array)."""
    ops = torch.full((int(ab_idx.shape[0]),), int(op_id), dtype=torch.int64,
                     device=ab_idx.device)
    return _universal(spec, cache_s, cache_f, ab_idx, ops, spoints, fpoints)


def segmented_ref(spec: ScreenSpec, cache_s, cache_f, ab_idx, row_ops,
                  spoints, fpoints):
    return _universal(spec, cache_s, cache_f, ab_idx, row_ops.to(torch.int64),
                      spoints, fpoints)


def _structured_ab(op_id: int, const_uid: int, big0: int, big: str, n: int,
                   device) -> torch.Tensor:
    contig = torch.arange(big0, big0 + n, dtype=torch.int32, device=device)
    const = torch.full((n,), const_uid, dtype=torch.int32, device=device)
    if big == "b" and op_id >= N_UNARY:
        return torch.stack([const, contig], dim=1)
    return torch.stack([contig, const], dim=1)


def structured_ref(spec: ScreenSpec, cache_s, cache_f, const_uid: int,
                   big0: int, op_id: int, spoints, fpoints, big: str,
                   n_batch: int):
    # torch slicing truncates where JAX's dynamic_slice clamps the start:
    # both are wrong for an out-of-range run, so refuse it
    assert big in ("a", "b") and n_batch % TILE == 0
    assert 0 <= big0 and big0 + n_batch <= cache_s.shape[0], \
        (big0, n_batch, cache_s.shape[0])
    ab = _structured_ab(int(op_id), int(const_uid), int(big0), big, n_batch,
                        cache_s.device)
    ops = torch.full((n_batch,), int(op_id), dtype=torch.int64,
                     device=cache_s.device)
    return _universal(spec, cache_s, cache_f, ab, ops, spoints, fpoints)


def tiled_ref(spec: ScreenSpec, cache_s, cache_f, starts, const_uid, opkind,
              spoints, fpoints, n_batch: int):
    assert n_batch % TILE == 0 and starts.shape[0] == n_batch // TILE
    starts = starts.to(torch.int64)
    assert int(starts.min()) >= 0 and \
        int(starts.max()) + TILE <= cache_s.shape[0], \
        "tiled run past the cache allocation"
    ok = opkind.to(torch.int64)
    op = ok >> 1
    lane = torch.arange(TILE, device=starts.device).repeat(n_batch // TILE)
    big = starts.repeat_interleave(TILE) + lane
    const = const_uid.to(torch.int64).repeat_interleave(TILE)
    op_rows = op.repeat_interleave(TILE)
    swap = ((ok & 1) == 1).repeat_interleave(TILE) & (op_rows >= N_UNARY)
    ab = torch.stack([torch.where(swap, const, big),
                      torch.where(swap, big, const)], dim=1)
    return _universal(spec, cache_s, cache_f, ab, op_rows, spoints, fpoints)


# ---------------------------------------------------------------------------
# CUDA entry points
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _outputs(spec: ScreenSpec, n: int, device):
    return (torch.empty((n, 3), dtype=torch.int32, device=device),
            torch.empty((n, spec.sdim), dtype=torch.float32, device=device),
            torch.empty((n, spec.fdim), dtype=torch.float32, device=device))


def _check_cache(spec: ScreenSpec, cache_s, cache_f, spoints):
    cap = int(cache_s.shape[0])
    _check(cache_s, "cache_s", torch.float32, (cap, spec.sdim))
    _check(cache_f, "cache_f", torch.float32, (cap, spec.fdim))
    _check(spoints, "spoints", torch.float32, (spec.n_screen, 2))
    if cap == 0:
        raise ValueError("empty jet cache")
    if cache_s.data_ptr() % 16 or cache_f.data_ptr() % 16:
        raise ValueError("the jet cache must be 16-byte aligned (the "
                         "kernels copy its rows in 16-byte and 8-byte "
                         "chunks)")
    return cap


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _one_device(kernel: str, *tensors) -> None:
    """Refuse tensors on more than one device: the library takes raw
    pointers and launches on the cache's device and its current stream,
    so a tensor elsewhere would be read through a wrong address."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) > 1:
        raise ValueError(f"{kernel}: tensors on more than one device: "
                         f"{sorted(str(d) for d in devs)}")


def segmented(spec: ScreenSpec, cache_s, cache_f, ab_idx, row_ops, spoints,
              fpoints):
    """Mixed-op batch (make_pallas_segmented_kernel): candidate ``i`` is
    op ``row_ops[i]`` (in ``[0, 18)``) on the cache rows ``ab_idx[i]``.
    Any ``n``: the caller packs each op's candidates back to back and
    passes exactly its candidates."""
    _one_device("segmented", cache_s, cache_f, ab_idx, row_ops, spoints,
                fpoints)
    if cache_s.device.type == "cpu":
        return _nan_checked("segmented", segmented_ref(
            spec, cache_s, cache_f, ab_idx, row_ops, spoints, fpoints),
            lambda i: row_ops[i])
    n = int(ab_idx.shape[0])
    cap = _check_cache(spec, cache_s, cache_f, spoints)
    _check(ab_idx, "ab_idx", torch.int32, (n, 2))
    _check(row_ops, "row_ops", torch.int32, (n,))
    packed, jets, fj = _outputs(spec, n, cache_s.device)
    if n:
        with torch.cuda.device(cache_s.device):
            rc = _library(spec).pde_screen_segmented(
                cache_s.data_ptr(), cache_f.data_ptr(), cap,
                ab_idx.data_ptr(), row_ops.data_ptr(), spoints.data_ptr(),
                spec.screen_rtol, n, jets.data_ptr(), fj.data_ptr(),
                packed.data_ptr(), _stream(cache_s.device))
        _raise_on(rc, "segmented")
        LAUNCHES["segmented"] += 1
    return _nan_checked("segmented", (packed, jets, fj),
                        lambda i: row_ops[i])


def structured(spec: ScreenSpec, cache_s, cache_f, const_uid: int, big0: int,
               op_id: int, spoints, fpoints, big: str, n_batch: int):
    """One op over a constant row and a contiguous run
    (make_pallas_structured_kernel); ``n_batch`` a multiple of the
    512-row tile, in blocks sized to the launch."""
    _one_device("structured", cache_s, cache_f, spoints, fpoints)
    if cache_s.device.type == "cpu":
        return _nan_checked("structured", structured_ref(
            spec, cache_s, cache_f, const_uid, big0, op_id, spoints,
            fpoints, big, n_batch), lambda i: op_id)
    if big not in ("a", "b") or n_batch % TILE:
        raise ValueError(f"bad structured batch: big={big!r}, n={n_batch}")
    cap = _check_cache(spec, cache_s, cache_f, spoints)
    if not (0 <= big0 and big0 + n_batch <= cap and 0 <= const_uid < cap):
        raise ValueError(f"structured run [{big0}, {big0 + n_batch}) or "
                         f"constant row {const_uid} outside {cap} rows")
    packed, jets, fj = _outputs(spec, n_batch, cache_s.device)
    if n_batch:
        with torch.cuda.device(cache_s.device):
            rc = _library(spec).pde_screen_structured(
                cache_s.data_ptr(), cache_f.data_ptr(), cap, int(const_uid),
                int(big0), int(op_id), int(big == "b"), spoints.data_ptr(),
                spec.screen_rtol, n_batch,
                block_cands(spec, "structured", n_batch), jets.data_ptr(),
                fj.data_ptr(), packed.data_ptr(), _stream(cache_s.device))
        _raise_on(rc, "structured")
        LAUNCHES["structured"] += 1
    return _nan_checked("structured", (packed, jets, fj), lambda i: op_id)


def tiled(spec: ScreenSpec, cache_s, cache_f, starts, const_uid, opkind,
          spoints, fpoints, n_batch: int):
    """Per-tile (op, kind, start, const) runs (make_pallas_tiled_kernel).
    The caller keeps every ``start + 512`` within the cache allocation;
    the kernel clamps rows as a memory guard."""
    _one_device("tiled", cache_s, cache_f, starts, const_uid, opkind,
                spoints, fpoints)
    if cache_s.device.type == "cpu":
        return _nan_checked("tiled", tiled_ref(
            spec, cache_s, cache_f, starts, const_uid, opkind, spoints,
            fpoints, n_batch), lambda i: opkind[i // TILE] >> 1)
    if n_batch % TILE:
        raise ValueError(f"batch of {n_batch} rows is not a multiple of "
                         f"{TILE}")
    cap = _check_cache(spec, cache_s, cache_f, spoints)
    nt = n_batch // TILE
    _check(starts, "starts", torch.int32, (nt,))
    _check(const_uid, "const_uid", torch.int32, (nt,))
    _check(opkind, "opkind", torch.int32, (nt,))
    packed, jets, fj = _outputs(spec, n_batch, cache_s.device)
    with torch.cuda.device(cache_s.device):
        rc = _library(spec).pde_screen_tiled(
            cache_s.data_ptr(), cache_f.data_ptr(), cap, starts.data_ptr(),
            const_uid.data_ptr(), opkind.data_ptr(), spoints.data_ptr(),
            spec.screen_rtol, n_batch, jets.data_ptr(), fj.data_ptr(),
            packed.data_ptr(), _stream(cache_s.device))
    _raise_on(rc, "tiled")
    LAUNCHES["tiled"] += 1
    return _nan_checked("tiled", (packed, jets, fj),
                        lambda i: opkind[i // TILE] >> 1)


def universal(spec: ScreenSpec, cache_s, cache_f, ab_idx, op_id: int,
              spoints, fpoints):
    """One op over per-row operands (make_pallas_universal_kernel /
    make_pallas_op_kernel).  Any ``n``, in blocks sized to the launch;
    out-of-range rows clamp, as the JAX gather does.  Every tensor lies
    on one device; on a card the launch goes to that card's current
    stream."""
    _one_device("universal", cache_s, cache_f, ab_idx, spoints, fpoints)
    if cache_s.device.type == "cpu":
        return _nan_checked("universal", universal_ref(
            spec, cache_s, cache_f, ab_idx, op_id, spoints, fpoints),
            lambda i: op_id)
    if not 0 <= int(op_id) < len(OP_ORDER):
        raise ValueError(f"op id {op_id} outside [0, {len(OP_ORDER)})")
    n = int(ab_idx.shape[0])
    cap = _check_cache(spec, cache_s, cache_f, spoints)
    _check(ab_idx, "ab_idx", torch.int32, (n, 2))
    packed, jets, fj = _outputs(spec, n, cache_s.device)
    if n:
        with torch.cuda.device(cache_s.device):
            rc = _library(spec).pde_screen_universal(
                cache_s.data_ptr(), cache_f.data_ptr(), cap,
                ab_idx.data_ptr(), int(op_id), spoints.data_ptr(),
                spec.screen_rtol, n, block_cands(spec, "universal", n),
                jets.data_ptr(), fj.data_ptr(), packed.data_ptr(),
                _stream(cache_s.device))
        _raise_on(rc, "universal")
        LAUNCHES["universal"] += 1
    return _nan_checked("universal", (packed, jets, fj), lambda i: op_id)
