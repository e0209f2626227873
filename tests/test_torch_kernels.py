"""The port's plain-torch screen kernels against the JAX package's.

``segmented_ref``, ``structured_ref``, ``tiled_ref`` and the per-op
``universal`` entry point (pde_engine_tpu_torch/parallel/cuda_engine.py;
on CPU tensors it runs its plain twin ``universal_ref``) against
``make_pallas_segmented/structured/tiled/universal_kernel(...,
interpret=True)``, and the mixed-op ``universal_ref`` against the XLA
``make_universal_kernel_raw``, on the same numpy-seeded cache with
snapped fingerprint rows: 2,048 rows per op and entry point (4,096 per
binary op in the tiled case, two kinds).

The JAX side runs in a subprocess with ``XLA_FLAGS`` set to
``--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp``, so that it
rounds every operation as the TPU and the CUDA kernels (``-fmad=false``)
do:

- XLA:CPU contracts ``x*y + z`` into an FMA whenever the target has one,
  and no compile option turns that off (``pde_engine_tpu/ops/jets.py:
  119-132``); AVX has no FMA instructions.  With the default ISA the
  contraction moved a fingerprint value across a quantization-cell edge
  on up to 1% of rows (segmented, 1,024 rows per op: exp_mul 99.02%,
  geom_sum 99.71%, div 99.80% of rows agreed);
- XLA's algebraic simplifier rewrites ``1 / sqrt(v)`` (``jets._v_pow``)
  into ``rsqrt(v)``, which rounds differently; with the rewrite on, sqrt,
  sqrt_shift_neg and sqrt_shift_pos agreed on 99.80-99.95% of rows.

On the torch side the ``xp`` rounds sqrt correctly on the CPU
(``ops/torch_xp.py``).  Tolerances, per op, for the fingerprint jets and
the packed words (fp_a, fp_b, flags, rel_max) together: every row
bit-equal (measured 100% in all four entry points), except where XLA's
and torch's exp and log round one ulp apart and a value falls on the
other side of a cell edge.  Measured shares, lowest over the four entry
points (2,048 rows per op each; 4,096 per binary op in the tiled case):

    exp, exp_mul, log_mul: 99.902% (2 rows of 2,048); exp_neg, log: 100%

and ``FP_FLOOR`` holds those three to 99.9%.  Screen jets are bit-equal
(NaN equal to NaN) for every op outside the exp/log family, and for
exp, exp_neg, log, exp_mul and log_mul ``allclose`` at rtol 2e-4 of each
point's largest coefficient magnitude, on finite values, with NaN/inf
positions equal on at least 99.9% of rows.

The CUDA kernels themselves are held bit-equal to these references on the
GPU (``test_cuda_kernels_match_ref`` below, run there with
``python -m pytest tests/test_torch_kernels.py -m gpu --noconftest``;
the suite's conftest imports jax, which the GPU machine does not have),
on full launches and on partial ones (segmented on a ragged row count
whose op runs end inside warps, tiled on fewer tiles).

On the CPU, the host build of the kernels' body (``csrc/host_harness.cpp``,
g++) runs the four kernels' candidate group with its warp shuffles
emulated in lane order (``host_screen_rows_grouped``); it is
held bit for bit equal to the one-thread-per-candidate body
(``host_screen_rows``) and, like that body, to the plain torch twin, for
all 18 ops on force_free (order 4) and laplace (order 2), on rows whose
jets are random, non-finite, all zero or constant.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.ops.jetops import UNARY_NAMES
from pde_engine_tpu_torch.parallel import cuda_engine as ce
from pde_engine_tpu_torch.parallel.incremental import (OP_INDEX, OP_ORDER,
                                                      universal_ref)
from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np
from pde_engine_tpu_torch.pipeline import cuda_emit_spec

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FP_FLOOR = {"exp": 0.999, "exp_mul": 0.999, "log_mul": 0.999}  # else 1.0
EXP_LOG = ("exp", "exp_neg", "log", "exp_mul", "log_mul")
MIN_SAME_MASK = 0.999     # rows whose non-finite jet positions agree
JET_RTOL = 2e-4
TILE = 512
PER_OP = 2048             # rows per op and entry point
C = 8192                  # cache rows
XLA_FLAGS = "--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's default pool (one thread per
    core in each worker) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# The JAX side: every Pallas kernel in interpret mode and the XLA
# universal kernel, on the inputs in argv[1]; outputs to argv[2].
_JAX_SIDE = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pde_engine_tpu.models import load_problem
from pde_engine_tpu.parallel import pallas_engine as pe
from pde_engine_tpu.parallel.incremental import make_universal_kernel_raw

x = dict(np.load(sys.argv[1]))
p = load_problem("force_free")
dims = (p.residual_order, p.get_residual_key(), float(p.screen_rtol),
        len(p.screen_points), len(p.fingerprint_points))
cs, cf = jnp.asarray(x["cache_s"]), jnp.asarray(x["cache_f"])
sp = jnp.asarray(p.screen_points, jnp.float32)
fp = jnp.asarray(p.fingerprint_points, jnp.float32)
i32 = lambda a: jnp.asarray(a, jnp.int32)
out = {}

def put(name, parts):
    for k, arrs in zip(("packed", "jets", "fj"), zip(*parts)):
        out[f"{name}/{k}"] = np.concatenate([np.asarray(a) for a in arrs])

seg = pe.make_pallas_segmented_kernel(*dims, interpret=True)
put("segmented", [seg(cs, cf, i32(x["seg_ab"]), i32(x["seg_ops"]), sp, fp)])
for big in ("a", "b"):
    kern = pe.make_pallas_structured_kernel(*dims, big, int(x["per_op"]),
                                            interpret=True)
    put(f"structured_{big}", [kern(cs, cf, i32(c), i32(b0), i32(op), sp, fp)
                              for op, c, b0 in x[f"str_{big}"]])
tiled = pe.make_pallas_tiled_kernel(*dims, len(x["til_opkind"]) * 512,
                                    interpret=True)
put("tiled", [tiled(cs, cf, i32(x["til_starts"]), i32(x["til_const"]),
                    i32(x["til_opkind"]), sp, fp)])
raw = jax.jit(make_universal_kernel_raw(*dims, compact=True))
put("universal", [raw(cs, cf, i32(ab), i32(op), sp, fp)
                  for op, ab in enumerate(x["uni_ab"])])
uni = pe.make_pallas_universal_kernel(*dims, interpret=True, compact=True)
put("pallas_universal", [uni(cs, cf, i32(ab), jnp.int32(op), sp, fp)
                         for op, ab in enumerate(x["uni_ab"])])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded inputs, and the JAX side's outputs on them."""
    problem = load_problem("force_free")
    spec = cuda_emit_spec(problem, problem.screen_rtol)
    rng = np.random.default_rng(0)
    s = rng.normal(0.0, 0.5, size=(C, 8, 15)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, 8))
    f = rng.normal(0.0, 0.5, size=(C, 6, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, 6))
    n_ops, n_un = len(OP_ORDER), len(UNARY_NAMES)
    tiles = PER_OP // TILE
    x = dict(cache_s=s.reshape(C, -1), cache_f=snap_fp_jets_np(
        f.reshape(C, -1)), per_op=np.int64(PER_OP))
    x["seg_ops"] = (np.arange(n_ops * tiles) % n_ops).astype(np.int32)
    x["seg_ab"] = rng.integers(0, C, size=(n_ops * PER_OP, 2),
                               dtype=np.int32)
    for big, ops in (("a", range(n_ops)), ("b", range(n_un, n_ops))):
        x[f"str_{big}"] = np.array(
            [(op, rng.integers(0, C), rng.integers(0, C - PER_OP))
             for op in ops], np.int32)
    combos = [(op, 0) for op in range(n_ops)] + [
        (op, 1) for op in range(n_un, n_ops)]
    opkind = np.array([o * 2 + k for o, k in combos for _ in range(tiles)],
                      np.int32)
    x["til_opkind"] = opkind
    x["til_starts"] = rng.integers(0, C - TILE, size=len(opkind),
                                   dtype=np.int32)
    x["til_const"] = rng.integers(0, C, size=len(opkind), dtype=np.int32)
    x["uni_ab"] = rng.integers(0, C, size=(n_ops, PER_OP, 2),
                               dtype=np.int32)
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, XLA_FLAGS=XLA_FLAGS,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    return dict(problem=problem, spec=spec, x=x,
                jax={k: tuple(out[f"{k}/{p}"] for p in ("packed", "jets",
                                                        "fj"))
                     for k in {n.split("/")[0] for n in out}})


def _torch_args(st):
    p, x = st["problem"], st["x"]
    return (torch.from_numpy(x["cache_s"]), torch.from_numpy(x["cache_f"]),
            torch.as_tensor(p.screen_points, dtype=torch.float32),
            torch.as_tensor(p.fingerprint_points, dtype=torch.float32))


def _shares(row_ops, jax_out, torch_out):
    """Per op: share of rows whose packed words and fingerprint jets are
    bit-equal (NaN equal to NaN), and whether the screen jets are."""
    jp, js, jf = (np.asarray(a) for a in jax_out)
    tp, ts, tf = (a.numpy() for a in torch_out)
    same_p = (jp.view(np.uint32) == tp.view(np.uint32)).all(axis=1)
    same_f = ((jf.view(np.uint32) == tf.view(np.uint32))
              | (np.isnan(jf) & np.isnan(tf))).all(axis=1)
    same_s = ((js.view(np.uint32) == ts.view(np.uint32))
              | (np.isnan(js) & np.isnan(ts))).all(axis=1)
    return {OP_ORDER[op]: (float((same_p & same_f)[row_ops == op].mean()),
                           bool(same_s[row_ops == op].all()))
            for op in np.unique(row_ops).tolist()}


def _agree(name, row_ops, jax_out, torch_out):
    """Per-op agreement of (packed, jets, fj) under the module's rules."""
    row_ops = np.asarray(row_ops)
    for op_name, (share, jets_equal) in _shares(row_ops, jax_out,
                                                torch_out).items():
        assert share >= FP_FLOOR.get(op_name, 1.0), (name, op_name, share)
        if op_name not in EXP_LOG:
            assert jets_equal, (name, op_name)
        rows = row_ops == OP_INDEX[op_name]
        a = np.asarray(jax_out[1])[rows].reshape(rows.sum(), -1, 15)
        b = torch_out[1].numpy()[rows].reshape(rows.sum(), -1, 15)
        a, b = a.astype(np.float64), b.astype(np.float64)
        fin = np.isfinite(a) & np.isfinite(b)
        same_mask = (np.isfinite(a) == np.isfinite(b)).all(axis=(1, 2))
        assert same_mask.mean() >= MIN_SAME_MASK, (name, op_name)
        big = np.max(np.where(fin, np.abs(b), 0.0), axis=-1, keepdims=True)
        err = np.where(fin, np.abs(a - b), 0.0)
        assert (err <= JET_RTOL * big).all(), (name, op_name, float(
            np.max(err / np.maximum(big, 1e-30))))


def _segmented(st):
    """The port's segmented entry on the JAX kernel's inputs, its op id
    per 512-row tile given per row."""
    x = st["x"]
    ts, tf, tsp, tfp = _torch_args(st)
    row_ops = np.repeat(x["seg_ops"], TILE)
    out = ce.segmented(st["spec"], ts, tf, torch.from_numpy(x["seg_ab"]),
                       torch.from_numpy(row_ops), tsp, tfp)
    return row_ops, out


def _structured(st, big):
    ts, tf, tsp, tfp = _torch_args(st)
    parts = [ce.structured(st["spec"], ts, tf, int(c), int(b0), int(op),
                           tsp, tfp, big, PER_OP)
             for op, c, b0 in st["x"][f"str_{big}"]]
    return (np.repeat(st["x"][f"str_{big}"][:, 0], PER_OP),
            tuple(torch.cat(p) for p in zip(*parts)))


def _tiled(st):
    x = st["x"]
    ts, tf, tsp, tfp = _torch_args(st)
    out = ce.tiled(st["spec"], ts, tf, torch.from_numpy(x["til_starts"]),
                   torch.from_numpy(x["til_const"]),
                   torch.from_numpy(x["til_opkind"]), tsp, tfp,
                   len(x["til_opkind"]) * TILE)
    return np.repeat(x["til_opkind"] // 2, TILE), out


def _universal(st):
    spec = st["spec"]
    ts, tf, tsp, tfp = _torch_args(st)
    parts = [universal_ref(spec.order, spec.residual_key, spec.screen_rtol,
                           spec.n_screen, spec.n_fp, ts, tf,
                           torch.from_numpy(ab),
                           torch.full((len(ab),), op, dtype=torch.int64),
                           tsp, tfp)
             for op, ab in enumerate(st["x"]["uni_ab"])]
    return (np.repeat(np.arange(len(OP_ORDER)), PER_OP),
            tuple(torch.cat(p) for p in zip(*parts)))


def test_op_order_matches_jax():
    from pde_engine_tpu.parallel.incremental import OP_INDEX as J_INDEX
    from pde_engine_tpu.parallel.incremental import OP_ORDER as J_ORDER
    from pde_engine_tpu.ops.jetops import UNARY_NAMES as J_UNARY
    assert OP_ORDER == J_ORDER
    assert tuple(UNARY_NAMES) == tuple(J_UNARY)
    assert OP_INDEX == J_INDEX
    assert ce.N_UNARY == len(UNARY_NAMES)


def test_segmented_ref_matches_pallas(setup):
    row_ops, out = _segmented(setup)
    _agree("segmented", row_ops, setup["jax"]["segmented"], out)


@pytest.mark.parametrize("big", ["a", "b"])
def test_structured_ref_matches_pallas(setup, big):
    row_ops, out = _structured(setup, big)
    _agree(f"structured[{big}]", row_ops, setup["jax"][f"structured_{big}"],
           out)


def test_tiled_ref_matches_pallas(setup):
    row_ops, out = _tiled(setup)
    _agree("tiled", row_ops, setup["jax"]["tiled"], out)


def test_universal_ref_matches_xla(setup):
    row_ops, out = _universal(setup)
    _agree("universal", row_ops, setup["jax"]["universal"], out)


def test_universal_entry_matches_pallas(setup):
    """``cuda_engine.universal``, one launch per op (on the CPU its plain
    twin ``universal_ref`` with a uniform op array), against the JAX
    per-op kernel ``make_pallas_universal_kernel`` for all 18 ops."""
    spec = setup["spec"]
    ts, tf, tsp, tfp = _torch_args(setup)
    parts = [ce.universal(spec, ts, tf, torch.from_numpy(ab), op, tsp, tfp)
             for op, ab in enumerate(setup["x"]["uni_ab"])]
    out = tuple(torch.cat(p) for p in zip(*parts))
    _agree("pallas_universal", np.repeat(np.arange(len(OP_ORDER)), PER_OP),
           setup["jax"]["pallas_universal"], out)


def test_universal_ref_any_batch_size(setup):
    """The per-op entry takes any n (no tile multiple): a ragged batch
    gives the rows of the full one."""
    spec = setup["spec"]
    ts, tf, tsp, tfp = _torch_args(setup)
    ab = torch.from_numpy(setup["x"]["uni_ab"][5])
    full = ce.universal(spec, ts, tf, ab, 5, tsp, tfp)
    part = ce.universal(spec, ts, tf, ab[:777], 5, tsp, tfp)
    for x, y in zip(part, full):
        assert torch.equal(x.view(torch.int32), y[:777].view(torch.int32))


def test_refs_refuse_out_of_range_runs(setup):
    """torch slicing would truncate where JAX's dynamic_slice clamps."""
    st, spec = setup, setup["spec"]
    ts, tf, tsp, tfp = _torch_args(st)
    with pytest.raises(AssertionError):
        ce.structured_ref(spec, ts, tf, 0, C - 100, 9, tsp, tfp, "a", TILE)
    starts = torch.tensor([C - 100], dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(AssertionError):
        ce.tiled_ref(spec, ts, tf, starts, zero, zero, tsp, tfp, TILE)


@pytest.mark.gpu
def test_cuda_kernels_match_ref():
    """On a GPU: the hand-written kernels are bit-equal to their plain
    torch versions (NaN equal to NaN) for every op and addressing mode,
    segmented and tiled also on partial launches (segmented on a ragged
    row count whose op runs end inside warps), the per-op kernel on a
    batch that is not a tile multiple and on 1, 17 and 502 rows,
    structured also at 4,096 rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (hand-written kernels have no CPU "
                    "mode)")
    problem = load_problem("force_free")
    spec = cuda_emit_spec(problem, problem.screen_rtol)
    rng = np.random.default_rng(0)
    s = rng.normal(0.0, 0.5, size=(C, 8, 15)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, 8))
    f = rng.normal(0.0, 0.5, size=(C, 6, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, 6))
    dev = torch.device("cuda")
    ts = torch.from_numpy(s.reshape(C, -1)).to(dev)
    tf = torch.from_numpy(snap_fp_jets_np(f.reshape(C, -1))).to(dev)
    tsp = torch.as_tensor(problem.screen_points, dtype=torch.float32,
                          device=dev)
    tfp = torch.as_tensor(problem.fingerprint_points, dtype=torch.float32,
                          device=dev)
    N = 9216
    ops = np.repeat(np.arange(N // TILE) % len(OP_ORDER), TILE)
    ab = rng.integers(0, C, size=(N, 2)).astype(np.int32)
    args = (torch.from_numpy(ab).to(dev),
            torch.from_numpy(ops.astype(np.int32)).to(dev), tsp, tfp)
    outs = [(ce.segmented(spec, ts, tf, *args),
             ce.segmented_ref(spec, ts, tf, *args))]
    for op in range(len(OP_ORDER)):
        for big in ("a", "b"):
            a = (7, 100, op, tsp, tfp, big, TILE)
            outs.append((ce.structured(spec, ts, tf, *a),
                         ce.structured_ref(spec, ts, tf, *a)))
    nt = N // TILE
    opkind = torch.from_numpy(
        (np.arange(nt) % len(OP_ORDER) * 2 + np.arange(nt) % 2)
        .astype(np.int32)).to(dev)
    starts = torch.from_numpy(rng.integers(
        0, C - TILE, size=nt).astype(np.int32)).to(dev)
    const = torch.from_numpy(rng.integers(
        0, C, size=nt).astype(np.int32)).to(dev)
    a = (starts, const, opkind, tsp, tfp, N)
    outs.append((ce.tiled(spec, ts, tf, *a), ce.tiled_ref(spec, ts, tf, *a)))
    # partial launches: segmented on 7,757 rows whose op runs of 1-200
    # rows end at any lane, tiled on the first 15 of 18 tiles
    live = N - 3 * TILE + 77
    ragged = np.repeat(np.arange(live) % len(OP_ORDER),
                       rng.integers(1, 200, size=live))[:live]
    part = (args[0][:live], torch.from_numpy(ragged.astype(np.int32)).to(dev),
            tsp, tfp)
    outs.append((ce.segmented(spec, ts, tf, *part),
                 ce.segmented_ref(spec, ts, tf, *part)))
    nt15 = 15
    a15 = (starts[:nt15], const[:nt15], opkind[:nt15], tsp, tfp, nt15 * TILE)
    outs.append((ce.tiled(spec, ts, tf, *a15),
                 ce.tiled_ref(spec, ts, tf, *a15)))
    assert all(x.shape[0] == live for x in outs[-2][0])
    assert all(x.shape[0] == nt15 * TILE for x in outs[-1][0])
    # universal: one op per launch over a ragged batch (no tile multiple)
    # and at the per-op path's small launches (1, 17 and 502 rows: one
    # step per block, the last ending inside a warp)
    for rows in (N - 100, 1, 17, 502):
        ab_u = torch.from_numpy(ab[:rows]).to(dev)
        for op in range(len(OP_ORDER)):
            a = (ab_u, op, tsp, tfp)
            outs.append((ce.universal(spec, ts, tf, *a),
                         ce.universal_ref(spec, ts, tf, *a)))
    # structured at --batch-size 4096's launch shape, both kinds; the
    # second run ends at the cache's last row
    for op in range(len(OP_ORDER)):
        for big, big0 in (("a", 1000), ("b", C - 4096)):
            a = (11, big0, op, tsp, tfp, big, 4096)
            outs.append((ce.structured(spec, ts, tf, *a),
                         ce.structured_ref(spec, ts, tf, *a)))
    torch.cuda.synchronize()
    for got, want in outs:
        for x, y in zip(got, want):
            x, y = x.cpu(), y.cpu()
            if x.dtype == torch.float32:
                same = (x.view(torch.int32) == y.view(torch.int32)) | (
                    torch.isnan(x) & torch.isnan(y))
            else:
                same = x == y
            assert bool(same.all())


@pytest.mark.parametrize("n", [1, 17, 502, 4096, 19021, 262144])
def test_block_size_rule_covers_the_launch(n):
    """The candidates per block of a structured or universal launch: one
    of 16, 32, 64 or 128 (each divides the 512-row tile, so a structured
    launch, a tile multiple, has no ragged block), the largest whose grid
    still fills the card's resident slots, else 16; the grid covers
    ``[0, n)`` exactly once."""
    for slots in (1, 132, 528, 4096):
        c = ce.candidates_per_block(n, slots)
        blocks = -(-n // c)  # the launchers' grid
        assert c in ce.GROUP_CANDS and TILE % c == 0
        rows = np.concatenate([np.arange(b * c, min((b + 1) * c, n))
                               for b in range(blocks)])
        assert np.array_equal(rows, np.arange(n))
        if c > min(ce.GROUP_CANDS):
            assert blocks >= slots
        if c < max(ce.GROUP_CANDS):
            assert -(-n // (2 * c)) < slots
        if n % TILE == 0:
            assert n % c == 0
    # the H100 holds 132 SMs x 4 blocks of these kernels
    assert [ce.candidates_per_block(m, 528) for m in (262144, 502, 4096)] \
        == [128, 16, 16]


@pytest.mark.parametrize("kernel", ["segmented", "tiled"])
def test_live_rows_are_a_prefix(setup, kernel):
    """A partial launch, its inputs cut to the live rows (segmented: any
    row count; tiled: whole tiles), screens and returns exactly the first
    rows of the full launch, through the plain twin and the entry point
    on CPU tensors; a tiled batch that is not whole tiles is refused."""
    x, spec = setup["x"], setup["spec"]
    ts, tf, tsp, tfp = _torch_args(setup)
    if kernel == "segmented":
        ab = torch.from_numpy(x["seg_ab"])
        ops = torch.from_numpy(np.repeat(x["seg_ops"], TILE))
        live = 5 * TILE + 77
        args, cut = (ab, ops, tsp, tfp), (ab[:live], ops[:live], tsp, tfp)
        ref, entry = ce.segmented_ref, ce.segmented
    else:
        tiles = [torch.from_numpy(x[k]) for k in ("til_starts", "til_const",
                                                  "til_opkind")]
        live = 5 * TILE
        args = (*tiles, tsp, tfp, len(x["til_opkind"]) * TILE)
        cut = (*(t[:5] for t in tiles), tsp, tfp, live)
        ref, entry = ce.tiled_ref, ce.tiled
    full = ref(spec, ts, tf, *args)
    for fn in (ref, entry):
        part = fn(spec, ts, tf, *cut)
        for p, f in zip(part, full):
            assert p.shape[0] == live
            assert torch.equal(p.view(torch.int32), f[:live].view(torch.int32))
    if kernel == "tiled":
        with pytest.raises(AssertionError):
            ref(spec, ts, tf, *cut[:5], live + 1)


HOST_ROWS_PER_OP = 240


@pytest.fixture(scope="module", params=["force_free", "laplace",
                                        "kerr_magnetosphere",
                                        "grad_shafranov"])
def host_rows(request):
    """Seeded operand rows screened by the host build of the body, one
    thread per candidate and as a candidate group, and by the plain torch
    twin.  Row i % 8 of each op: 0-3 random, 4 a non-finite a row, 5 all
    zero a and b rows, 6 constant a and b rows (only the value
    coefficients set), 7 an infinite b value."""
    import shutil

    from pde_engine_tpu_torch.utils.cuda_build import load_host_library
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    p = load_problem(request.param)
    spec = cuda_emit_spec(p, p.screen_rtol)
    lib = load_host_library(ce.header_text(spec))
    T = spec.sdim // spec.n_screen
    rng = np.random.default_rng(3)
    n = HOST_ROWS_PER_OP * len(OP_ORDER)
    a_s, b_s = (rng.normal(size=(n, spec.n_screen, T)).astype(np.float32)
                for _ in range(2))
    a_f, b_f = (rng.normal(size=(n, spec.n_fp, 3)).astype(np.float32)
                for _ in range(2))
    kind = np.arange(n) % 8
    a_s[kind == 4, 0, T - 1] = np.nan
    a_f[kind == 4, 1, 0] = np.inf
    for arr in (a_s, b_s, a_f, b_f):
        arr[kind == 5] = 0.0
        arr[kind == 6, :, 1:] = 0.0
    b_s[kind == 7, 2, 0] = -np.inf
    b_f[kind == 7, 0, 0] = np.inf
    a_s, b_s = (np.ascontiguousarray(v.reshape(n, -1)) for v in (a_s, b_s))
    a_f, b_f = (snap_fp_jets_np(v.reshape(n, -1)) for v in (a_f, b_f))
    ops = np.repeat(np.arange(len(OP_ORDER), dtype=np.int32),
                    HOST_ROWS_PER_OP)
    sp = np.ascontiguousarray(p.screen_points, np.float32)
    outs = {}
    for name in ("host_screen_rows", "host_screen_rows_grouped"):
        o = (np.zeros((n, 3), np.uint32), np.zeros((n, spec.sdim), np.float32),
             np.zeros((n, spec.fdim), np.float32))
        getattr(lib, name)(n, ops.ctypes.data, a_s.ctypes.data,
                           a_f.ctypes.data, b_s.ctypes.data, b_f.ctypes.data,
                           sp.ctypes.data, float(spec.screen_rtol),
                           o[1].ctypes.data, o[2].ctypes.data,
                           o[0].ctypes.data)
        outs[name] = o
    ab = torch.from_numpy(np.stack([np.arange(n), np.arange(n) + n], 1)
                          .astype(np.int32))
    plain = universal_ref(spec.order, spec.residual_key, spec.screen_rtol,
                          spec.n_screen, spec.n_fp,
                          torch.from_numpy(np.concatenate([a_s, b_s])),
                          torch.from_numpy(np.concatenate([a_f, b_f])), ab,
                          torch.from_numpy(ops.astype(np.int64)),
                          torch.from_numpy(sp))
    outs["plain"] = (plain[0].numpy().view(np.uint32), plain[1].numpy(),
                     plain[2].numpy())
    flags = outs["plain"][0][:, 2] & 15
    # the special rows reach every flag: screen pass, non-finite, constant
    assert (flags & 1).any() and (flags & 2).any() and (flags & 4).any()
    return spec, ops, outs


def _bits_equal(x, y):
    return ((x.view(np.uint32) == y.view(np.uint32))
            | (np.isnan(x) & np.isnan(y)))


def _hold_to_plain(spec, op_name, got, plain, m):
    """Packed words and snapped fingerprint jets bit-equal to the plain
    twin; screen jets bit-equal outside exp/log, else within 32 ulp of
    each point's largest coefficient (test_torch_emit.py says why)."""
    assert np.array_equal(got[0][m], plain[0][m])
    assert _bits_equal(got[2][m], plain[2][m]).all()
    if op_name not in EXP_LOG:
        assert _bits_equal(got[1][m], plain[1][m]).all()
        return
    T = spec.sdim // spec.n_screen
    x = got[1][m].reshape(-1, spec.n_screen, T).astype(np.float64)
    y = plain[1][m].reshape(-1, spec.n_screen, T).astype(np.float64)
    fin = np.isfinite(y)
    assert (np.isfinite(x) == fin).all()
    big = np.max(np.where(fin, np.abs(y), 0.0), axis=-1, keepdims=True)
    ulp = np.spacing(big.astype(np.float32)).astype(np.float64)
    assert (np.where(fin, np.abs(x - y), 0.0) <= 32 * ulp).all()


@pytest.mark.parametrize("op_name", OP_ORDER)
def test_host_group_body_matches(host_rows, op_name):
    """The candidate group (the body of all four CUDA kernels) is bit
    for bit the one-thread-per-candidate body, and holds to the plain
    twin as that body does."""
    spec, ops, outs = host_rows
    m = ops == OP_INDEX[op_name]
    grouped, single = outs["host_screen_rows_grouped"], outs["host_screen_rows"]
    for g, s1 in zip(grouped, single):
        assert np.array_equal(g[m].view(np.uint32), s1[m].view(np.uint32))
    _hold_to_plain(spec, op_name, grouped, outs["plain"], m)


@pytest.mark.parametrize("op_name", OP_ORDER)
def test_host_candidate_body_matches_plain(host_rows, op_name):
    """``screen_candidate``, now a loop over the per-point pieces, still
    equals the plain twin on the four problems' specs (order 4 and
    the three order-2 residuals) and the special rows."""
    spec, ops, outs = host_rows
    _hold_to_plain(spec, op_name, outs["host_screen_rows"], outs["plain"],
                   ops == OP_INDEX[op_name])
