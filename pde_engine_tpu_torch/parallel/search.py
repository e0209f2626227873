"""Verdicts, fingerprint keys and the compact verdict packing in torch.

Counterpart of ``pde_engine_tpu/parallel/search.py``: the same rules in
the same float32 arithmetic, so that a batch screened here and one
screened by the JAX package agree bit for bit on the same jets.  The
float64 NumPy pieces (``snap_fp_jets_np``, ``verdicts_from_jets_np``,
``unpack_screen_result_compact``) are copies, because the JAX module that
holds them imports jax.

Torch has only partial ``uint32`` arithmetic, so every 32-bit unsigned
quantity (FNV folds, bit patterns) lives in ``int64`` masked to 32 bits
and crosses back to an ``int32`` bit pattern at the packing boundary.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.interpreter import batched_evaluator

MASK32 = 0xFFFFFFFF


class ScreenResult(NamedTuple):
    screen_ok: object    # bool[N]  — passes relative-residual screen
    rel_max: object      # f32[N]   — max relative residual over points
    nonfinite: object    # bool[N]  — residual/scale non-finite anywhere
    is_const: object     # bool[N]  — gradient exactly zero everywhere
    fp_a: object         # uint32[N] — fingerprint hash (mix A)
    fp_b: object         # uint32[N] — fingerprint hash (mix B)
    fp_finite: object    # bool[N]  — fingerprint values all finite
    fp_vals: object      # f32[N, F*3] — snapped fingerprint values


_SENTINEL = np.float32(2.9183e7)  # stands in for non-finite fp values

SCALE_FLOOR = 1e-25  # f32 near-underflow: below this a point is blind
JET_TINY = 1e-20     # healthy jet coefficients are exactly 0 or above this
SCALE_FLOOR64 = 1e-180
JET_TINY64 = 1e-150
REL_EPS = 1e-30      # denominator guard of the f32 relative residual

FNV_A = (0x01000193, 0x811C9DC5)   # (multiplier, seed)
FNV_B = (0x85EBCA6B, 0xC2B2AE35)


def f32(c: float) -> float:
    """``c`` rounded to float32: the value JAX and torch use when a Python
    float meets a float32 array, exact in either precision."""
    return float(np.float32(c))


def u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 value -> int32 with the same bit pattern."""
    x = x & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def i32_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> int64 holding the uint32 value."""
    return x.to(torch.int64) & MASK32


def _quantize_parts(v: torch.Tensor):
    """Canonical (mantissa-cell, exponent) split shared by the key and the
    grid snap (see the JAX module): 12-bit mantissa, ties to even
    (``torch.round`` like ``jnp.round``), and the ±4096 rollover
    renormalized to (±2048, e+1)."""
    v = torch.where(torch.isfinite(v), v,
                    torch.full_like(v, float(_SENTINEL)))
    m, e = torch.frexp(v)
    q = torch.round(m * 4096.0).to(torch.int32)
    roll = torch.abs(q) == 4096
    q = torch.where(roll, q >> 1, q)
    e = torch.where(roll, e + 1, e).to(torch.int32)
    return q, e


def _quantize(v: torch.Tensor) -> torch.Tensor:
    """f32 -> stable int32 key (see _quantize_parts)."""
    q, e = _quantize_parts(v)
    return q * 1024 + torch.clamp(e, -500, 500)


def snap_fp_jets(v: torch.Tensor) -> torch.Tensor:
    """Snap fingerprint-jet values onto the centers of their quantization
    cells with the integer bit-ops of the JAX ``snap_fp_jets``: add
    2047 + kept-lsb, clear the low 12 mantissa bits; |v| < 2^-126 flushes
    to +0; non-finite values pass through."""
    b = i32_to_u32(v.contiguous().view(torch.int32))
    lsb = (b >> 12) & 1
    r = (b + 2047 + lsb) & 0xFFFFF000
    s = u32_to_i32(r).view(torch.float32)
    s = torch.where(torch.abs(v) < f32(2.0 ** -126), torch.zeros_like(s), s)
    return torch.where(torch.isfinite(v), s, v)


def snap_fp_jets_np(v: np.ndarray) -> np.ndarray:
    """NumPy float32 mirror of :func:`snap_fp_jets` — the same integer
    bit-ops, hence bit-identical to the device snap on every input."""
    vv = np.ascontiguousarray(v, dtype=np.float32)
    with np.errstate(all="ignore"):
        b = vv.view(np.uint32)
        lsb = (b >> np.uint32(12)) & np.uint32(1)
        r = (b + np.uint32(2047) + lsb) & np.uint32(0xFFFFF000)
        s = r.view(np.float32).copy()
        s[np.abs(vv) < np.float32(2.0 ** -126)] = np.float32(0.0)
        fin = np.isfinite(vv)
        s[~fin] = vv[~fin]
    return s


def _mul_u32(h: torch.Tensor, mult: int) -> torch.Tensor:
    """(h * mult) mod 2^32 for h in [0, 2^32), without int64 overflow:
    the multiplier is split into 16-bit halves."""
    lo = h * (mult & 0xFFFF)
    hi = ((h * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _fold_hash(keys: torch.Tensor, mult: int, seed: int) -> torch.Tensor:
    """FNV-style fold over the last axis; int64 holding uint32 values."""
    k64 = keys.to(torch.int64) & MASK32
    h = torch.full(keys.shape[:-1], seed, dtype=torch.int64,
                   device=keys.device)
    for k in range(keys.shape[-1]):
        h = _mul_u32(h, mult) ^ k64[..., k]
    return h


def informative_points(res, scale, jets):
    """Which collocation points give a trustworthy verdict (see the JAX
    module for the underflow-garbage vs structural-zero rule).  Floors are
    dtype-aware; accepts torch tensors or NumPy arrays."""
    if isinstance(res, torch.Tensor):
        f64 = res.dtype == torch.float64
        floor = SCALE_FLOOR64 if f64 else f32(SCALE_FLOOR)
        tiny = JET_TINY64 if f64 else f32(JET_TINY)
        abs_j = torch.abs(jets)
        coeff_ok = (abs_j == 0.0) | (abs_j > tiny)
        healthy = (torch.all(coeff_ok, dim=-1)
                   & ~torch.all(abs_j == 0.0, dim=-1))
        structural = (scale == 0.0) & (res == 0.0) & healthy
        return (scale > floor) | structural
    f64 = res.dtype == np.float64
    floor = SCALE_FLOOR64 if f64 else SCALE_FLOOR
    tiny = JET_TINY64 if f64 else JET_TINY
    abs_j = np.abs(jets)
    coeff_ok = (abs_j == 0.0) | (abs_j > tiny)
    healthy = np.all(coeff_ok, axis=-1) & ~np.all(abs_j == 0.0, axis=-1)
    structural = (scale == 0.0) & (res == 0.0) & healthy
    return (scale > floor) | structural


def verdicts_from_parts(res, scale, jets, fj,
                        screen_rtol: float) -> ScreenResult:
    """Verdicts from (residual, scale) ``[N, P]``, screen jets
    ``[N, P, T]`` and snapped fingerprint jets ``[N, F, 3]``."""
    rel = torch.abs(res) / (scale + f32(REL_EPS))
    finite = torch.isfinite(res) & torch.isfinite(scale)
    informative = informative_points(res, scale, jets)
    nonfinite_any = torch.any(~finite, dim=-1)
    ok_pt = finite & informative
    any_inform = torch.any(ok_pt, dim=-1)
    rel_max = torch.where(
        any_inform,
        torch.amax(torch.where(ok_pt, rel, torch.zeros_like(rel)), dim=-1),
        torch.full_like(rel[..., 0], float("inf")))
    screen_ok = (~nonfinite_any) & any_inform & (rel_max < f32(screen_rtol))

    flat = fj.reshape(fj.shape[0], -1)
    fp_finite = torch.all(torch.isfinite(flat), dim=-1)
    keys = _quantize(flat)
    fp_a = _fold_hash(keys, *FNV_A)
    fp_b = _fold_hash(keys, *FNV_B)

    grads = torch.abs(fj[..., 1:])
    grad_max = torch.amax(grads.reshape(fj.shape[0], -1), dim=-1)
    val_ok = torch.all(torch.isfinite(fj[..., 0]), dim=-1)
    is_const = (grad_max == 0.0) & val_ok
    return ScreenResult(screen_ok, rel_max, nonfinite_any, is_const,
                        fp_a, fp_b, fp_finite, flat)


def verdicts_from_jets(jets, fj, spoints, residual_fn,
                       screen_rtol: float) -> ScreenResult:
    """Residual screen + fingerprint + constant detection from screen-order
    jets ``[N, P, T]`` and snapped order-1 fingerprint jets ``[N, F, 3]``."""
    from ..ops.torch_xp import txp
    res, scale = residual_fn(jets, spoints, txp)
    return verdicts_from_parts(res, scale, jets, fj, screen_rtol)


def pack_screen_result_compact(sr: ScreenResult) -> torch.Tensor:
    """12 B/candidate packing as int32 bit patterns ``[N, 3]``:
    fp_a, fp_b, and rel_max's bf16 round-UP in the high half with the
    flags (screen_ok, nonfinite, is_const, fp_finite) in bits 0-3."""
    i64 = torch.int64
    flags = (sr.screen_ok.to(i64)
             | (sr.nonfinite.to(i64) << 1)
             | (sr.is_const.to(i64) << 2)
             | (sr.fp_finite.to(i64) << 3))
    rel_bits = i32_to_u32(sr.rel_max.to(torch.float32).contiguous()
                          .view(torch.int32))
    col2 = ((rel_bits + 0xFFFF) & 0xFFFF0000) | flags
    return torch.stack([u32_to_i32(sr.fp_a), u32_to_i32(sr.fp_b),
                        u32_to_i32(col2)], dim=1)


N_PACK_HEAD = 9   # verdict columns ahead of the fingerprint values


def pack_screen_result(sr: ScreenResult) -> torch.Tensor:
    """The full packing as one float32 array ``[N, 9 + F*3]``: screen_ok,
    rel_max, nonfinite, is_const, fp_a and fp_b each as two exact 16-bit
    halves, fp_finite, then the snapped fingerprint values (JAX
    ``pack_screen_result``)."""
    f = torch.float32
    fa, fb = sr.fp_a, sr.fp_b
    cols = [sr.screen_ok.to(f), sr.rel_max.to(f), sr.nonfinite.to(f),
            sr.is_const.to(f), (fa >> 16).to(f), (fa & 0xFFFF).to(f),
            (fb >> 16).to(f), (fb & 0xFFFF).to(f), sr.fp_finite.to(f)]
    return torch.cat([torch.stack(cols, dim=1), sr.fp_vals.to(f)], dim=1)


def unpack_screen_result(packed: np.ndarray) -> ScreenResult:
    """Host-side inverse of :func:`pack_screen_result` (numpy arrays)."""
    packed = np.ascontiguousarray(packed, dtype=np.float32)

    def u32(hi, lo):
        return ((hi.astype(np.uint32) << np.uint32(16))
                | lo.astype(np.uint32))

    return ScreenResult(
        screen_ok=packed[:, 0] != 0, rel_max=packed[:, 1],
        nonfinite=packed[:, 2] != 0, is_const=packed[:, 3] != 0,
        fp_a=u32(packed[:, 4], packed[:, 5]),
        fp_b=u32(packed[:, 6], packed[:, 7]),
        fp_finite=packed[:, 8] != 0, fp_vals=packed[:, N_PACK_HEAD:])


class CompactUnpack(NamedTuple):
    sr: ScreenResult
    n_passers: int          # passer count
    passer_idx: np.ndarray  # batch indices of the passers


def unpack_screen_result_compact(packed: np.ndarray,
                                 n_fp: int) -> CompactUnpack:
    """Host-side inverse of the compact packing.  ``fp_vals`` is a zeros
    array — the pipeline scatters in the passer rows it gathers from the
    device."""
    body = np.ascontiguousarray(packed).view(np.uint32)
    n = body.shape[0]
    col2 = body[:, 2]
    rel = (col2 & np.uint32(0xFFFF0000)).view(np.float32)
    screen_ok = (col2 & 1) != 0
    idx = np.nonzero(screen_ok)[0].astype(np.int32)
    sr = ScreenResult(
        screen_ok=screen_ok,
        rel_max=rel,
        nonfinite=(col2 & 2) != 0,
        is_const=(col2 & 4) != 0,
        fp_a=body[:, 0],
        fp_b=body[:, 1],
        fp_finite=(col2 & 8) != 0,
        fp_vals=np.zeros((n, n_fp * 3), np.float32),
    )
    return CompactUnpack(sr=sr, n_passers=int(idx.size), passer_idx=idx)


def verdicts_from_jets_np(jets, fj, spoints, residual_fn,
                          screen_rtol: float) -> ScreenResult:
    """NumPy float64 verdicts for the handful of tape-evaluated
    expressions (primitives, known solutions); fingerprints are snapped
    and keyed in float32 like the device path."""
    res, scale = residual_fn(jets, spoints, np)
    with np.errstate(all="ignore"):
        rel = np.abs(res) / (scale + 1e-300)
        finite = np.isfinite(res) & np.isfinite(scale)
        informative = informative_points(res, scale, jets)
        nonfinite_any = np.any(~finite, axis=-1)
        ok_pt = finite & informative
        any_inform = np.any(ok_pt, axis=-1)
        rel_max = np.where(
            any_inform,
            np.max(np.where(ok_pt, rel, 0.0), axis=-1),
            np.inf)
        screen_ok = (~nonfinite_any) & any_inform & (rel_max < screen_rtol)

        flat = snap_fp_jets_np(
            fj.reshape(fj.shape[0], -1).astype(np.float32))
        fp_finite = np.all(np.isfinite(flat), axis=-1)
        v = np.where(np.isfinite(flat), flat, _SENTINEL)
        m, e = np.frexp(v)
        q = np.round(m * 4096.0).astype(np.int32)
        roll = np.abs(q) == 4096
        q = np.where(roll, q >> 1, q)
        e = np.where(roll, e + 1, e)
        keys = q * 1024 + np.clip(e, -500, 500)
        h_a = np.full(keys.shape[:-1], FNV_A[1], np.uint32)
        h_b = np.full(keys.shape[:-1], FNV_B[1], np.uint32)
        for k in range(keys.shape[-1]):
            kk = keys[..., k].astype(np.uint32)
            h_a = (h_a * np.uint32(FNV_A[0])) ^ kk
            h_b = (h_b * np.uint32(FNV_B[0])) ^ kk

        grads = np.abs(fj[..., 1:])
        grad_max = np.max(grads.reshape(fj.shape[0], -1), axis=-1)
        val_ok = np.all(np.isfinite(fj[..., 0]), axis=-1)
        is_const = (grad_max == 0.0) & val_ok

    return ScreenResult(screen_ok, rel_max.astype(np.float32),
                        nonfinite_any, is_const, h_a, h_b, fp_finite, flat)


@functools.lru_cache(maxsize=None)
def make_search_kernel_raw(order: int, max_nodes: int, residual_key: str,
                           screen_rtol: float, n_screen: int, n_fp: int):
    """The fused tape screen for a (problem, bucket) combination:
    ``kernel(tapes, lengths, consts, spoints, fpoints) -> ScreenResult``.
    Tapes are interpreted at the screen order over the screen points and
    at order 1 over the fingerprint points (:func:`batched_evaluator`),
    the fingerprint jets snapped, and the verdicts taken as on every other
    path; it runs on the device of its inputs.  ``residual_key`` selects
    the residual from the registry below.  ``n_screen`` and ``n_fp`` key
    the cache only, as in the JAX package."""
    residual_fn = _RESIDUALS[residual_key]
    eval_r = batched_evaluator(order, max_nodes)
    eval_1 = batched_evaluator(1, max_nodes)

    def kernel(tapes, lengths, consts, spoints, fpoints):
        jets = eval_r(tapes, lengths, consts, spoints)        # [N, P, T]
        fj = snap_fp_jets(eval_1(tapes, lengths, consts, fpoints))
        return verdicts_from_jets(jets, fj, spoints, residual_fn,
                                  screen_rtol)

    return kernel


@functools.lru_cache(maxsize=None)
def make_tape_jets_kernel(order: int, max_nodes: int, residual_key: str,
                          screen_rtol: float, n_screen: int, n_fp: int):
    """Like :func:`make_search_kernel`, but returns the full packing
    (:func:`pack_screen_result`) with the flattened screen jets ``[N,
    P*T]`` and snapped fingerprint jets ``[N, F*3]``, the rows that seed a
    ``JetCache`` (JAX ``make_tape_jets_kernel``).  Runs on the device of
    its inputs."""
    residual_fn = _RESIDUALS[residual_key]
    eval_r = batched_evaluator(order, max_nodes)
    eval_1 = batched_evaluator(1, max_nodes)

    def kernel(tapes, lengths, consts, spoints, fpoints):
        jets = eval_r(tapes, lengths, consts, spoints)
        # snapped, so that the rows sit on the incremental kernels' grid
        fj = snap_fp_jets(eval_1(tapes, lengths, consts, fpoints))
        sr = verdicts_from_jets(jets, fj, spoints, residual_fn, screen_rtol)
        return (pack_screen_result(sr), jets.reshape(jets.shape[0], -1),
                fj.reshape(fj.shape[0], -1))

    return kernel


def make_search_kernel(order: int, max_nodes: int, residual_key: str,
                       screen_rtol: float, n_screen: int, n_fp: int):
    """The JAX package's jitted :func:`make_search_kernel_raw`; torch runs
    eagerly, so it is that kernel itself."""
    return make_search_kernel_raw(order, max_nodes, residual_key,
                                  screen_rtol, n_screen, n_fp)


# Residual registry (string-keyed so compiled kernels are cacheable).
def _ff(jets, pts, xp):
    from ..models.residuals import foliation_residual
    return foliation_residual(jets, pts, xp, omega=0.0)


def _ff_rot(omega):
    from ..models.residuals import foliation_residual
    return lambda jets, pts, xp: foliation_residual(jets, pts, xp,
                                                    omega=omega)


def _kerr(jets, pts, xp):
    from ..models.residuals import kerr_residual
    return kerr_residual(jets, pts, xp)


def _laplace(jets, pts, xp):
    from ..models.residuals import laplace_residual
    return laplace_residual(jets, pts, xp)


def _gs(jets, pts, xp):
    from ..models.residuals import grad_shafranov_residual
    return grad_shafranov_residual(jets, pts, xp)


_RESIDUALS = {
    "force_free": _ff,
    "force_free_omega1": _ff_rot(1.0),
    "kerr_magnetosphere": _kerr,
    "laplace": _laplace,
    "grad_shafranov": _gs,
}


def register_residual(key: str, fn) -> None:
    _RESIDUALS[key] = fn
