"""Truncated bivariate Taylor polynomials in float64 NumPy.

A value here is an array ``[..., K]`` of the Taylor coefficients of a
function of two variables (x, y) about a point, for every monomial
x**i * y**j with i + j <= order, in the order of :func:`monomials`.  The
coefficient of x**i * y**j is d^(i+j) u / dx^i dy^j divided by i! j!.

Written for the benchmark's plain reference: it shares no code with the
program under test.  Sums and products are exact Taylor arithmetic; an
elementary function f of a polynomial u is the composition
sum_k f^(k)(u0) / k! * (u - u0)**k, truncated at the order.

Beside each value the reference carries a first-order bound on its
roundoff, coefficient by coefficient (``mul_error``, ``compose_error``),
so that a number that is zero in exact arithmetic can be told from one
that is small.
"""

from __future__ import annotations

from functools import lru_cache
from math import factorial
from typing import Callable, Tuple

import numpy as np

U = 2.0 ** -53      # float64's unit roundoff


@lru_cache(maxsize=None)
def monomials(order: int) -> Tuple[Tuple[int, int], ...]:
    """(i, j) exponent pairs, by total degree, then by falling i."""
    return tuple((d - j, j) for d in range(order + 1) for j in range(d + 1))


@lru_cache(maxsize=None)
def _index(order: int):
    return {m: k for k, m in enumerate(monomials(order))}


@lru_cache(maxsize=None)
def _product_terms(order: int) -> Tuple[Tuple[int, Tuple[Tuple[int, int], ...]], ...]:
    """For each output coefficient, the input coefficient pairs whose
    monomials multiply to it."""
    idx = _index(order)
    out = []
    for (i, j) in monomials(order):
        pairs = tuple((idx[(a, b)], idx[(i - a, j - b)])
                      for a in range(i + 1) for b in range(j + 1))
        out.append((idx[(i, j)], pairs))
    return tuple(out)


def n_coeffs(order: int) -> int:
    return len(monomials(order))


def variable(values: np.ndarray, which: int, order: int) -> np.ndarray:
    """The polynomial of coordinate ``which`` (0: x, 1: y) about each of
    ``values``'s points, shape ``[P, K]``."""
    out = np.zeros(values.shape[:-1] + (n_coeffs(order),))
    out[..., 0] = values[..., which]
    if order:
        out[..., _index(order)[(1, 0) if which == 0 else (0, 1)]] = 1.0
    return out


def constant(c: float, shape, order: int) -> np.ndarray:
    out = np.zeros(tuple(shape) + (n_coeffs(order),))
    out[..., 0] = c
    return out


def mul(u: np.ndarray, v: np.ndarray, order: int) -> np.ndarray:
    out = np.empty(np.broadcast_shapes(u.shape, v.shape))
    for k, pairs in _product_terms(order):
        acc = u[..., pairs[0][0]] * v[..., pairs[0][1]]
        for a, b in pairs[1:]:
            acc = acc + u[..., a] * v[..., b]
        out[..., k] = acc
    return out


def _series(h: np.ndarray, cs, order: int) -> np.ndarray:
    """sum_k cs[k] * h**k for a polynomial h whose constant term is 0."""
    out = np.zeros_like(h)
    out[..., 0] = cs[0]
    power = h
    for k in range(1, order + 1):
        out = out + cs[k][..., None] * power
        if k < order:
            power = mul(power, h, order)
    return out


def _shifted(u: np.ndarray) -> np.ndarray:
    h = u.copy()
    h[..., 0] = 0.0
    return h


def compose(u: np.ndarray, derivs: Callable[[np.ndarray, int], np.ndarray],
            order: int) -> np.ndarray:
    """f(u) from ``derivs(u0, k)``, the k-th derivative of f at u0 over
    k!, for k = 0..order."""
    u0 = u[..., 0]
    return _series(_shifted(u), [derivs(u0, k) for k in range(order + 1)],
                   order)


def mul_error(u, eu, v, ev, order: int) -> np.ndarray:
    """A bound on the roundoff of ``mul(u, v)`` given bounds ``eu`` and
    ``ev`` on its factors': what they carry in, and each coefficient's sum
    of at most K products."""
    au, av = np.abs(u), np.abs(v)
    return (mul(au, ev, order) + mul(eu, av, order) + mul(eu, ev, order)
            + n_coeffs(order) * U * mul(au, av, order))


def compose_error(u: np.ndarray, eu: np.ndarray, derivs, order: int
                  ) -> np.ndarray:
    """A bound on the roundoff of ``compose(u, derivs)`` given a bound
    ``eu`` on u's: f'(u) * eu, carried in, and the sum's own, bounded by
    the same sum over the terms' magnitudes."""
    u0, h = u[..., 0], _shifted(u)
    with np.errstate(all="ignore"):
        fprime = _series(h, [(k + 1) * derivs(u0, k + 1)
                             for k in range(order + 1)], order)
        size = _series(np.abs(h), [np.abs(derivs(u0, k))
                                   for k in range(order + 1)], order)
    return (mul(np.abs(fprime), eu, order)
            + (n_coeffs(order) + 2 * order) * U * size)


def _binom(p: float, k: int) -> float:
    c = 1.0
    for m in range(k):
        c *= (p - m)
    return c / factorial(k)


def power_derivs(p: float) -> Callable[[np.ndarray, int], np.ndarray]:
    """The derivatives of u**p over k! (NaN where u0 < 0 and p is not
    whole, inf where u0 = 0 and a term has a negative power)."""
    def derivs(u0, k):
        with np.errstate(all="ignore"):
            return _binom(p, k) * np.power(u0, p - k)
    return derivs


def exp_derivs(u0, k):
    with np.errstate(all="ignore"):
        return np.exp(u0) / factorial(k)


def log_derivs(u0, k):
    with np.errstate(all="ignore"):
        if k == 0:
            return np.log(u0)
        return (-1.0) ** (k + 1) / (k * np.power(u0, float(k)))


def power(u: np.ndarray, p: float, order: int) -> np.ndarray:
    return compose(u, power_derivs(p), order)


def exp(u: np.ndarray, order: int) -> np.ndarray:
    return compose(u, exp_derivs, order)


def log(u: np.ndarray, order: int) -> np.ndarray:
    return compose(u, log_derivs, order)


def derivative(u: np.ndarray, i: int, j: int, order: int) -> np.ndarray:
    """d^(i+j) u / dx^i dy^j at the expansion point."""
    return u[..., _index(order)[(i, j)]] * (factorial(i) * factorial(j))


def derivatives(u: np.ndarray, order: int) -> dict:
    """Every partial derivative up to the order, keyed by (i, j)."""
    return {m: derivative(u, m[0], m[1], order) for m in monomials(order)}

