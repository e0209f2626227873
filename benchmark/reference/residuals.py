"""What the residuals of ``residual_<problem>.py`` share.

A problem's residual is a module ``residual_<problem>.py`` beside this
one, found by the name in the configuration's ``reference.residual``,
with ``ORDER``, the Taylor order it needs, and ``residual(d, de,
points)``.  It takes ``d``, the partial derivatives of u at a set of points
keyed by (i, j) (see ``taylor.derivatives``), ``de``, a bound on their
roundoff, and the points ``[..., 2]``, and returns ``(res, scale,
bound)``.  ``scale`` bounds the magnitude of the terms: the same sum with
every term's absolute value, so that a residual that vanishes by
cancellation reads as a small share of it.  ``bound`` bounds the
residual's roundoff, carried from ``de`` through every sum and product.
The verdict's relative residual is ``|res| / scale``.

Each is written out term by term from its equation, without the
program's jet algebra.
"""

from __future__ import annotations

import numpy as np

from .taylor import U


class Term:
    """A value with its magnitude bound and its roundoff bound: sums add
    magnitudes, products multiply them; each operation adds its own
    rounding to what its operands carry in."""

    __slots__ = ("v", "m", "e")

    def __init__(self, v, m=None, e=None):
        self.v = v
        self.m = np.abs(v) if m is None else m
        self.e = U * np.abs(v) if e is None else e

    def __add__(self, o):
        o = lift(o)
        v = self.v + o.v
        return Term(v, self.m + o.m, self.e + o.e + U * np.abs(v))

    __radd__ = __add__

    def __sub__(self, o):
        o = lift(o)
        v = self.v - o.v
        return Term(v, self.m + o.m, self.e + o.e + U * np.abs(v))

    def __rsub__(self, o):
        return lift(o) - self

    def __mul__(self, o):
        o = lift(o)
        v = self.v * o.v
        return Term(v, self.m * o.m,
                     np.abs(self.v) * o.e + self.e * np.abs(o.v)
                     + self.e * o.e + U * np.abs(v))

    __rmul__ = __mul__


def lift(x) -> Term:
    return x if isinstance(x, Term) else Term(x)




def load(name: str):
    """The module ``residual_<name>.py`` of this package."""
    import importlib
    return importlib.import_module(f"{__package__}.residual_{name}")
