"""A sound certificate that a tape's function is not constant.

Forward-mode, first-order interval evaluation of ``(u, u_X, u_Y)`` over a
batch of padded tapes (``[n, L, 3]`` int32 in :mod:`ops.optable` opcodes,
as ``Enumerator.tapes_batch`` returns them) at each screen point, in
float64 with outward rounding:

- the variables are the points' float64 values, held as degenerate
  intervals (exact real points of the domain);
- a constant is ``[nextafter(c, -inf), nextafter(c, +inf)]`` of
  ``float(Fraction)``, which holds the rational;
- every add, sub and mul result (a multiplication takes the min and max of
  the four products) is widened outward by one ulp, which covers IEEE
  round-to-nearest;
- every exp, log and power result is widened by a relative 2**-46 and one
  ulp more (over 64 ulps), since the library functions are not correctly
  rounded.

A point is undecided wherever a node leaves the real domain on which it is
analytic (log's argument not strictly positive, a non-integer power's
argument not strictly positive, a negative power's argument holding 0) or
any bound is NaN or infinite.  A row is certified when, at some screen
point, every node is inside its domain and the ``u_X`` or the ``u_Y``
enclosure excludes 0.  There the function is analytic with a nonzero
partial derivative, so it is not constant, and no exact derivative of it
(SymPy's included) is the zero expression.

Which problems' heavy checks this decides is the caller's choice
(``pipeline._CERTIFIED_CHECKS``); this module knows no problem.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Sequence

import numpy as np

from . import optable as ot

# rows per sub-batch: its node buffer is MAX_ROWS * L * P * 48 bytes for
# tapes of L nodes at P points
MAX_ROWS = 512

_REL = 2.0 ** -46           # library-function widening, relative
_TINY = 2.0 ** -1000        # and absolute, for results near 0
_BINARY = (ot.ADD, ot.SUB, ot.MUL)


def _down(x):
    return np.nextafter(x, -np.inf)


def _up(x):
    return np.nextafter(x, np.inf)


def _down_lib(x):
    return np.nextafter(x - (np.abs(x) * _REL + _TINY), -np.inf)


def _up_lib(x):
    return np.nextafter(x + (np.abs(x) * _REL + _TINY), np.inf)


# An enclosure is a (lo, hi) pair of arrays whose last axis holds
# (u, u_X, u_Y).

def _add(a, b):
    return _down(a[0] + b[0]), _up(a[1] + b[1])


def _sub(a, b):
    return _down(a[0] - b[1]), _up(a[1] - b[0])


def _mul(a, b):
    p = (a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1])
    lo = np.minimum(np.minimum(p[0], p[1]), np.minimum(p[2], p[3]))
    hi = np.maximum(np.maximum(p[0], p[1]), np.maximum(p[2], p[3]))
    return _down(lo), _up(hi)


def _part(a, s):
    return a[0][..., s], a[1][..., s]


def _join(val, grad):
    return (np.concatenate((val[0], grad[0]), axis=-1),
            np.concatenate((val[1], grad[1]), axis=-1))


def _monotone(fn, lo, hi):
    """The enclosure of a function monotone on [lo, hi]."""
    flo, fhi = fn(lo), fn(hi)
    return (_down_lib(np.minimum(flo, fhi)), _up_lib(np.maximum(flo, fhi)))


def _unary(val, der, a):
    """A unary node of value ``val``: the chain rule, ``der`` enclosing
    the outer derivative over ``a``'s value."""
    return _join(val, _mul(der, _part(a, slice(1, 3))))


def _pow(a, k: Fraction):
    """``a ** k``, and the points where ``a`` leaves its domain."""
    lo, hi = _part(a, slice(0, 1))
    if k.denominator != 1:
        out = lo <= 0
    elif k < 0:
        out = (lo <= 0) & (hi >= 0)
    else:
        out = np.zeros(lo.shape, bool)
    e, d = float(k), float(k - 1)
    val = _monotone(lambda x: np.power(x, e), lo, hi)
    if k == 2:                  # not monotone across 0
        val = (np.where((lo < 0) & (hi > 0), 0.0, val[0]), val[1])
    der = _monotone(lambda x: e * np.power(x, d), lo, hi)
    return _unary(val, der, a), out[..., 0]


def _const_bounds(consts: Sequence[Fraction]) -> np.ndarray:
    c = np.array([float(Fraction(v)) for v in consts] or [0.0], np.float64)
    return np.stack([_down(c), _up(c)], axis=-1)


def _certify_block(tapes, lengths, cb, points) -> np.ndarray:
    n, P = tapes.shape[0], points.shape[0]
    L = int(lengths.max())
    # each node's enclosure at each point: [..., 0, :] lo, [..., 1, :] hi
    buf = np.zeros((L, n, P, 2, 3), np.float64)
    bad = np.zeros((n, P), bool)
    var = {}
    for code, j in ((ot.VAR0, 0), (ot.VAR1, 1)):
        x = np.zeros((P, 3))
        x[:, 0], x[:, 1 + j] = points[:, j], 1.0
        var[code] = np.stack((x, x), axis=-2)
    value = slice(0, 1)
    for i in range(L):
        opc, ia, ib = tapes[:, i, 0], tapes[:, i, 1], tapes[:, i, 2]
        live = i < lengths
        for code in np.unique(opc[live]):
            r = np.flatnonzero(live & (opc == code))
            if code in var:
                buf[i, r] = var[code]
                continue
            if code == ot.CONST:
                buf[i, r] = 0.0
                buf[i, r, :, :, 0] = cb[ib[r]][:, None, :]
                continue
            node = buf[ia[r], r]
            a = node[..., 0, :], node[..., 1, :]
            dom = None
            if code == ot.NEG:
                out = -a[1], -a[0]
            elif code in _BINARY:
                node = buf[ib[r], r]
                b = node[..., 0, :], node[..., 1, :]
                if code == ot.ADD:
                    out = _add(a, b)
                elif code == ot.SUB:
                    out = _sub(a, b)
                else:
                    av, bv = _part(a, value), _part(b, value)
                    grad = _add(_mul(_part(a, slice(1, 3)), bv),
                                _mul(av, _part(b, slice(1, 3))))
                    out = _join(_mul(av, bv), grad)
            elif code == ot.EXP:
                val = _monotone(np.exp, *_part(a, value))
                out = _unary(val, val, a)
            elif code == ot.LOG:
                lo, hi = _part(a, value)
                dom = lo[..., 0] <= 0
                out = _unary(_monotone(np.log, lo, hi),
                             _monotone(np.reciprocal, lo, hi), a)
            elif code == ot.POW:
                out = np.zeros(a[0].shape), np.zeros(a[0].shape)
                dom = np.zeros(a[0].shape[:-1], bool)
                for pi in np.unique(ib[r]):
                    s = ib[r] == pi
                    o, dom[s] = _pow((a[0][s], a[1][s]),
                                     ot.POW_EXPONENTS[int(pi)])
                    out[0][s], out[1][s] = o
            else:               # no enclosure: the row stays undecided
                bad[r] = True
                continue
            buf[i, r] = np.stack(out, axis=-2)
            if dom is not None:
                bad[r] |= dom
        bad |= live[:, None] & ~np.isfinite(buf[i]).all(axis=(-1, -2))
    g = buf[lengths - 1, np.arange(n)]
    nonzero = ((g[..., 0, 1:] > 0) | (g[..., 1, 1:] < 0)).any(axis=-1)
    return (nonzero & ~bad).any(axis=-1)


def _certify_rows(tapes, lengths, cb, points) -> np.ndarray:
    out = np.zeros(len(lengths), bool)
    for i in range(0, len(lengths), MAX_ROWS):
        s = slice(i, i + MAX_ROWS)
        L = int(lengths[s].max())
        out[s] = _certify_block(tapes[s, :L], lengths[s], cb, points)
    return out


def certify(tapes: np.ndarray, lengths: np.ndarray,
            consts: Sequence[Fraction], points: np.ndarray) -> np.ndarray:
    """bool[n]: the rows proved not constant at one of ``points`` (f64
    ``[P, 2]``), in sub-batches of at most :data:`MAX_ROWS` rows.  The
    first point alone certifies nearly every row, at a fraction of the
    cost of all of them; the other points are tried on the rest."""
    lengths = np.asarray(lengths, np.int64)
    points = np.asarray(points, np.float64)
    cb = _const_bounds(consts)
    with np.errstate(all="ignore"):
        out = _certify_rows(tapes, lengths, cb, points[:1])
        rest = np.flatnonzero(~out)
        out[rest] = _certify_rows(tapes[rest], lengths[rest], cb, points[1:])
    return out
