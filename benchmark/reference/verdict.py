"""The plain reference's verdict on stored expressions.

It reads an expression as the run DB spells it (``neg(inv(X))``,
``(rho * pow_neg_3_2(rho**2 + z**2))``, ``log_mul(1, X**2 + Y**2)``, or a
known solution's ``rho**2/(rho**2 + z**2)**(3/2)``) with Python's own
parser, evaluates its Taylor polynomials in float64 at the problem's
points, and decides whether it solves the PDE.  It imports nothing of the
program and takes nothing the program made but the spelling.

A row is a solution when its polynomials are finite at every screen point
(values and gradients at the fingerprint points), it is not constant, at
least one screen point is informative (its residual's magnitude bound
above 1e-180, or residual, bound and roundoff all exactly 0), and the
relative residual ``|res| / scale`` is below ``rtol`` at every
informative screen point.  The screen computes in float32, so a number
beyond float32's range counts as not finite.

Beside every value the reference carries a bound on its float64
roundoff, so that a zero of exact arithmetic is told from a small
number:

- a row is constant when its largest gradient is at most 1e-12 of its
  largest value, or when every gradient at every screen point is within
  its roundoff bound, as for ``(1 - (rho * inv(rho)))``, which is 0;
- at a point where ``scale``, the sum of the residual's terms'
  magnitudes, is within the residual's roundoff bound, every term is
  roundoff, and the residual is zero in exact arithmetic, as for
  ``sqrt(square((rho - z)))`` under force_free or ``square(sqrt(X))``
  under laplace.  Whether the relative residual reads 0 or about 1 there
  hangs on the rounding of the arithmetic that computes it, so a row
  that no other point rejects is ``undecided``: neither verdict
  contradicts the reference.

Rows are evaluated in blocks; inside a block, a subexpression that several
rows share is evaluated once, and subexpressions of one kind at one height
are evaluated together.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Sequence

import numpy as np

from . import taylor
from . import residuals

UNARY = {
    "neg": lambda a: ("neg", a),
    "inv": lambda a: ("pow", a, -1.0),
    "sqrt": lambda a: ("pow", a, 0.5),
    "square": lambda a: ("mul", a, a),
    "pow_3_2": lambda a: ("pow", a, 1.5),
    "pow_neg_3_2": lambda a: ("pow", a, -1.5),
    "exp": lambda a: ("exp", a),
    "log": lambda a: ("log", a),
}
F32_MAX = float(np.finfo(np.float32).max)
BINARY = ("geom_sum", "sqrt_shift_neg", "sqrt_shift_pos", "exp_mul",
          "log_mul")


class Graph:
    """Expressions as a graph of shared subexpressions."""

    def __init__(self, var_names: Sequence[str]):
        self.var_names = tuple(var_names)
        self.nodes: List[tuple] = []
        self.height: List[int] = []
        self._ids: Dict[tuple, int] = {}

    def _node(self, key: tuple) -> int:
        i = self._ids.get(key)
        if i is None:
            kids = [k for k in key[1:] if isinstance(k, _Ref)]
            i = len(self.nodes)
            self._ids[key] = i
            self.nodes.append(key)
            self.height.append(1 + max((self.height[k.i] for k in kids),
                                       default=0))
        return i

    def ref(self, key: tuple) -> "_Ref":
        return _Ref(self._node(key))

    def add(self, spelling: str) -> int:
        tree = ast.parse(spelling.strip(), mode="eval").body
        return self._walk(tree).i

    def _const(self, tree) -> float:
        """The value of a constant subtree (an exponent such as 3/2)."""
        if isinstance(tree, ast.Constant) and isinstance(tree.value,
                                                         (int, float)):
            return float(tree.value)
        if isinstance(tree, ast.UnaryOp) and isinstance(tree.op, ast.USub):
            return -self._const(tree.operand)
        if isinstance(tree, ast.BinOp):
            a, b = self._const(tree.left), self._const(tree.right)
            ops = {ast.Add: a + b, ast.Sub: a - b, ast.Mult: a * b}
            if isinstance(tree.op, ast.Div):
                return a / b
            if type(tree.op) in ops:
                return ops[type(tree.op)]
        raise ValueError(f"not a constant: {ast.unparse(tree)}")

    def _pow(self, a: "_Ref", p: float) -> "_Ref":
        if p == 2.0:
            return self.ref(("mul", a, a))
        if p == 1.0:
            return a
        return self.ref(("pow", a, p))

    def _walk(self, t) -> "_Ref":
        if isinstance(t, ast.Name):
            if t.id not in self.var_names:
                raise ValueError(f"unknown name {t.id!r}")
            return self.ref(("var", self.var_names.index(t.id)))
        if isinstance(t, ast.Constant):
            return self.ref(("const", self._const(t)))
        if isinstance(t, ast.UnaryOp):
            if isinstance(t.op, ast.USub):
                return self.ref(("neg", self._walk(t.operand)))
            if isinstance(t.op, ast.UAdd):
                return self._walk(t.operand)
        if isinstance(t, ast.BinOp):
            if isinstance(t.op, ast.Pow):
                return self._pow(self._walk(t.left), self._const(t.right))
            a, b = self._walk(t.left), self._walk(t.right)
            if isinstance(t.op, ast.Add):
                return self.ref(("add", a, b))
            if isinstance(t.op, ast.Sub):
                return self.ref(("sub", a, b))
            if isinstance(t.op, ast.Mult):
                return self.ref(("mul", a, b))
            if isinstance(t.op, ast.Div):
                return self.ref(("mul", a, self.ref(("pow", b, -1.0))))
        if isinstance(t, ast.Call) and isinstance(t.func, ast.Name):
            name, args = t.func.id, [self._walk(x) for x in t.args]
            if name in UNARY and len(args) == 1:
                return self.ref(UNARY[name](args[0]))
            if name == "exp_neg" and len(args) == 1:
                return self.ref(("exp", self.ref(("neg", args[0]))))
            if name in BINARY and len(args) == 2:
                return self._binary(name, *args)
        raise ValueError(f"cannot read {ast.unparse(t)!r}")

    def _binary(self, name: str, a: "_Ref", b: "_Ref") -> "_Ref":
        one = self.ref(("const", 1.0))
        if name == "geom_sum":      # a / (1 - b)
            return self.ref(("mul", a, self.ref(
                ("pow", self.ref(("sub", one, b)), -1.0))))
        if name in ("sqrt_shift_neg", "sqrt_shift_pos"):
            # sqrt((a -+ 1)**2 + b**2)
            s = self.ref(("sub" if name.endswith("neg") else "add", a, one))
            tot = self.ref(("add", self.ref(("mul", s, s)),
                            self.ref(("mul", b, b))))
            return self.ref(("pow", tot, 0.5))
        if name == "exp_mul":       # a * exp(b)
            return self.ref(("mul", a, self.ref(("exp", b))))
        return self.ref(("mul", a, self.ref(("log", b))))   # log_mul

    def evaluate(self, points: np.ndarray, order: int):
        """Taylor polynomials of every node at ``points`` and a bound on
        each coefficient's roundoff: two ``[N, P, K]`` arrays."""
        n, K = len(self.nodes), taylor.n_coeffs(order)
        P = points.shape[0]
        out, err = np.empty((n, P, K)), np.empty((n, P, K))
        groups: Dict[tuple, List[int]] = {}
        for i, key in enumerate(self.nodes):
            tag = key[0] if key[0] != "pow" else ("pow", key[2])
            groups.setdefault((self.height[i], tag), []).append(i)
        with np.errstate(all="ignore"):
            for (_, tag), ids in sorted(groups.items(),
                                        key=lambda kv: kv[0][0]):
                idx = np.array(ids)
                keys = [self.nodes[i] for i in ids]
                op = tag if isinstance(tag, str) else tag[0]
                if op == "var":
                    for i, k in zip(ids, keys):
                        out[i] = taylor.variable(points, k[1], order)
                        err[i] = 0.0
                    continue
                if op == "const":
                    for i, k in zip(ids, keys):
                        out[i] = taylor.constant(k[1], (P,), order)
                        err[i] = taylor.U * np.abs(out[i])
                    continue
                ia = np.array([k[1].i for k in keys])
                a, ea = out[ia], err[ia]
                if op in ("add", "sub", "mul"):
                    ib = np.array([k[2].i for k in keys])
                    b, eb = out[ib], err[ib]
                    if op == "mul":
                        out[idx] = taylor.mul(a, b, order)
                        err[idx] = taylor.mul_error(a, ea, b, eb, order)
                    else:
                        out[idx] = a + b if op == "add" else a - b
                        err[idx] = ea + eb + taylor.U * np.abs(out[idx])
                elif op == "neg":
                    out[idx], err[idx] = -a, ea
                else:
                    derivs = (taylor.power_derivs(tag[1]) if op == "pow"
                              else taylor.exp_derivs if op == "exp"
                              else taylor.log_derivs)
                    out[idx] = taylor.compose(a, derivs, order)
                    err[idx] = taylor.compose_error(a, ea, derivs, order)
        return out, err


class _Ref:
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __eq__(self, o):
        return isinstance(o, _Ref) and o.i == self.i

    def __hash__(self):
        return hash(("ref", self.i))


def polynomials(spellings: Sequence[str], var_names, points: np.ndarray,
                order: int):
    """Taylor polynomials ``[N, P, K]`` of each spelling at ``points``,
    and the bound on their roundoff."""
    g = Graph(var_names)
    roots = np.array([g.add(s) for s in spellings], dtype=np.int64)
    out, err = g.evaluate(points, order)
    return out[roots], err[roots]


def judge(spellings: Sequence[str], problem: dict,
          block: int = 4096) -> Dict[str, np.ndarray]:
    """The reference's verdict on each spelling.  ``problem`` holds
    ``residual``, ``var_names``, ``screen_points``, ``fingerprint_points``
    and ``rtol``.  Returns per row: ``solution``, ``undecided`` (a
    solution whose residual is roundoff at some screen point and is
    decided by no other), ``rel_screen`` (the largest relative residual
    at informative screen points where it is not roundoff, inf if no
    point is informative), ``finite`` and ``constant``."""
    mod = residuals.load(problem["residual"])
    fn, order = mod.residual, mod.ORDER
    S = np.asarray(problem["screen_points"], np.float64)
    F = np.asarray(problem["fingerprint_points"], np.float64)
    pts = np.concatenate([S, F])
    nS, nF = len(S), len(F)
    rtol = float(problem["rtol"])
    cols = {k: [] for k in ("solution", "undecided", "rel_screen", "finite",
                            "constant")}
    for lo in range(0, len(spellings), block):
        u, eu = polynomials(spellings[lo:lo + block], problem["var_names"],
                            pts, order)
        with np.errstate(all="ignore"):
            d, de = taylor.derivatives(u, order), taylor.derivatives(eu, order)
            # the screen is float32: a number beyond its range is not
            # finite there
            finite = ((np.abs(u[:, :nS]) <= F32_MAX).all(axis=(1, 2))
                      & (np.abs(u[:, nS:nS + nF, :3]) <= F32_MAX).all(
                          axis=(1, 2)))
            gx, gy = np.abs(d[(1, 0)][:, :nS]), np.abs(d[(0, 1)][:, :nS])
            constant = ((np.maximum(gx, gy).max(axis=1)
                         <= 1e-12 * np.abs(d[(0, 0)][:, :nS]).max(axis=1))
                        | ((gx <= de[(1, 0)][:, :nS])
                           & (gy <= de[(0, 1)][:, :nS])).all(axis=1))
            res, scale, bound = fn(d, de, pts)
            finite &= ((np.abs(res[:, :nS]) <= F32_MAX)
                       & (scale[:, :nS] <= F32_MAX)).all(axis=1)
            exact = (scale == 0) & (res == 0) & (bound == 0)
            roundoff = (scale <= bound) & ~exact
            ok = (np.isfinite(res) & np.isfinite(scale) & np.isfinite(bound)
                  & ((scale > 1e-180) | exact | roundoff))[:, :nS]
            rel = np.where(ok & ~roundoff[:, :nS] & ~exact[:, :nS],
                           np.abs(res[:, :nS]) / scale[:, :nS], 0.0)
            rel_screen = np.where(ok.any(axis=1), rel.max(axis=1), np.inf)
        solution = finite & ~constant & (rel_screen < rtol)
        undecided = solution & (ok & roundoff[:, :nS]).any(axis=1)
        for k, v in (("solution", solution), ("undecided", undecided),
                     ("rel_screen", rel_screen),
                     ("finite", finite), ("constant", constant)):
            cols[k].append(v)
    return {k: (np.concatenate(v) if v else np.zeros(0))
            for k, v in cols.items()}


def values(spellings: Sequence[str], var_names, points) -> np.ndarray:
    """Values ``[N, P]`` of each spelling at ``points`` (order 0)."""
    return polynomials(spellings, var_names,
                       np.asarray(points, np.float64), 0)[0][..., 0]


def domain_points(rng: np.random.Generator, box, n: int) -> np.ndarray:
    """``n`` points drawn uniformly in ``box`` = [[x0, x1], [y0, y1]]."""
    box = np.asarray(box, np.float64)
    return box[:, 0] + (box[:, 1] - box[:, 0]) * rng.random((n, 2))

