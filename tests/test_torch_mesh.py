"""The port's mesh paths (``--devices K``) against one device and against
the JAX package's, on the CPU.

- The replicated mesh call (``incremental.make_op_kernel_sharded``) on a
  mesh of 4 CPU shards and the uid-range call
  (``make_op_kernel_uidrange``) on a cache split over 4 shards, all 18
  ops, an uneven batch among them: bit for bit the rows of one
  ``universal_ref`` over the whole cache, and the summed survivors the
  count of bit 0.  The same inputs go through the JAX package's
  ``make_op_kernel_sharded`` and ``make_op_kernel_uidrange`` on an
  8-device CPU mesh (a subprocess, with ``test_torch_kernels.py``'s XLA
  flags, the batch padded to a multiple of 8 and cut back), held to
  ``test_torch_kernels.py``'s rule (``_agree``): verdict and fingerprint
  bits equal on every row outside the exp/log family and on at least
  99.9% of rows inside it, screen jets bit-equal outside the family and
  within rtol 2e-4 inside it.  ``test_torch_kernels.py`` holds exp_neg
  and log to every row, as measured on its inputs; on these, exp_neg's
  fingerprint differs on 1 row of 2,048 (a value one ulp apart before
  the snap, on the other side of a cell edge: the family's rounding
  difference), so here the whole family shares the 99.9% floor.
- The sharded ``JetCache``: growth by a row quantum of K, appends that
  straddle a slice boundary, snapshots across slices, resume seeding,
  scattered rows, against a one-device cache.
- The engine on a mesh ``[cpu, cpu]``, replicated and ``shard_cache``,
  laplace and force_free to depth 3: the one-device per-op run's rows,
  row for row; against the JAX engine on a 2-device CPU mesh
  (``use_pallas=False, use_segmented=False``): depths 1-2 exact, depth 3
  within 0.2%, the same knowns.  The shard-cache window check: a window
  of ``n // 2 + 1`` rows a shard truncates nothing.
- ``dryrun_multichip(8, "cpu")`` and ``bench --devices 2 --device cpu``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.parallel import cuda_engine as ce
from pde_engine_tpu_torch.parallel.incremental import (
    OP_ORDER, JetCache, make_op_kernel_sharded, make_op_kernel_uidrange,
    universal_ref)
from pde_engine_tpu_torch.parallel.mesh import (CandidateMesh,
                                                candidate_mesh,
                                                shard_ranges)
from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np
from pde_engine_tpu_torch.pipeline import DiscoveryEngine, cuda_emit_spec
from pde_engine_tpu_torch.utils.config import SearchConfig
from test_torch_kernels import XLA_FLAGS, _agree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 8192          # cache rows (a multiple of the JAX mesh's 8 devices)
PER_OP = 2048     # rows per op, as in test_torch_kernels.py
UNEVEN = 2045     # the uneven batch: 512 + 511 + 511 + 511 over 4 shards
SHARDS = 4
D3_SPREAD = 0.002


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_SIDE = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
import jax.numpy as jnp
from pde_engine_tpu.models import load_problem
from pde_engine_tpu.parallel.incremental import (make_op_kernel_sharded,
                                                 make_op_kernel_uidrange,
                                                 OP_ORDER)
from pde_engine_tpu.parallel.mesh import candidate_mesh

x = dict(np.load(sys.argv[1]))
p = load_problem("force_free")
kw = dict(order=p.residual_order, residual_key=p.get_residual_key(),
          screen_rtol=float(p.screen_rtol), n_screen=len(p.screen_points),
          n_fp=len(p.fingerprint_points))
mesh = candidate_mesh(8)
cs, cf = jnp.asarray(x["cache_s"]), jnp.asarray(x["cache_f"])
sp = jnp.asarray(p.screen_points, jnp.float32)
fp = jnp.asarray(p.fingerprint_points, jnp.float32)
out = {}
for kind, make in (("sharded", make_op_kernel_sharded),
                   ("uidrange", make_op_kernel_uidrange)):
    parts = []
    for op, ab in enumerate(x["ab"]):
        n = len(ab) if op else int(x["uneven"])
        pad = np.zeros((-(-n // 8) * 8, 2), np.int32)
        pad[:n] = ab[:n]
        res = make(mesh, OP_ORDER[op], **kw)(cs, cf, jnp.asarray(pad), sp,
                                             fp)
        parts.append([np.asarray(a)[:n] for a in res[:3]])
    for i, k in enumerate(("packed", "jets", "fj")):
        out[f"{kind}/{k}"] = np.concatenate([q[i] for q in parts])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Seeded cache and batches (op 0's batch cut to the uneven size), and
    the JAX side's outputs on them."""
    problem = load_problem("force_free")
    spec = cuda_emit_spec(problem, problem.screen_rtol)
    rng = np.random.default_rng(11)
    s = rng.normal(0.0, 0.5, size=(C, 8, 15)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, 8))
    f = rng.normal(0.0, 0.5, size=(C, 6, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, 6))
    x = dict(cache_s=s.reshape(C, -1),
             cache_f=snap_fp_jets_np(f.reshape(C, -1)),
             ab=rng.integers(0, C, size=(len(OP_ORDER), PER_OP, 2),
                             dtype=np.int32),
             uneven=np.int64(UNEVEN))
    d = tmp_path_factory.mktemp("jax_mesh_side")
    np.savez(d / "in.npz", **x)
    env = dict(os.environ, XLA_FLAGS=XLA_FLAGS,
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    r = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(d / "in.npz"),
                        str(d / "out.npz")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = dict(np.load(d / "out.npz"))
    jax_out = {k: tuple(out[f"{k}/{p}"] for p in ("packed", "jets", "fj"))
               for k in ("sharded", "uidrange")}
    return dict(problem=problem, spec=spec, x=x, jax=jax_out)


def _batches(st):
    """(op id, ab) per op, op 0's batch uneven."""
    return [(op, ab[:UNEVEN] if op == 0 else ab)
            for op, ab in enumerate(st["x"]["ab"])]


def _points(st):
    p = st["problem"]
    return (torch.as_tensor(p.screen_points, dtype=torch.float32),
            torch.as_tensor(p.fingerprint_points, dtype=torch.float32))


def _mesh_cache(st, mesh, sharded):
    spec = st["spec"]
    cache = JetCache(spec.n_screen, spec.sdim // spec.n_screen, spec.n_fp,
                     "cpu", initial_capacity=C, mesh=mesh, sharded=sharded)
    cache.load_rows(st["x"]["cache_s"], st["x"]["cache_f"])
    return cache


def _run_mesh(st, kind):
    """The port's mesh call of ``kind`` on every op's batch, against one
    ``universal_ref`` over the whole cache: bit-equal rows, survivors the
    count of bit 0.  Returns (row ops, outputs concatenated)."""
    spec = st["spec"]
    mesh = CandidateMesh(["cpu"] * SHARDS)
    cache = _mesh_cache(st, mesh, kind == "uidrange")
    make = (make_op_kernel_uidrange if kind == "uidrange"
            else make_op_kernel_sharded)
    sp, fp = _points(st)
    whole = (torch.from_numpy(st["x"]["cache_s"]),
             torch.from_numpy(st["x"]["cache_f"]))
    parts, row_ops = [], []
    for op, ab in _batches(st):
        got = make(mesh, OP_ORDER[op], spec.order, spec.residual_key,
                   spec.screen_rtol, spec.n_screen, spec.n_fp)(
            cache, torch.from_numpy(ab), sp, fp)
        ref = universal_ref(spec.order, spec.residual_key, spec.screen_rtol,
                            spec.n_screen, spec.n_fp, *whole,
                            torch.from_numpy(ab),
                            torch.full((len(ab),), op), sp, fp)
        for a, b in zip(got[:3], ref):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                (kind, OP_ORDER[op])
        assert int(got[3]) == int((ref[0][:, 2] & 1).sum()), (kind, op)
        parts.append(got[:3])
        row_ops.append(np.full(len(ab), op))
    return (np.concatenate(row_ops),
            tuple(torch.cat(p) for p in zip(*parts)))


@pytest.mark.parametrize("kind", ["sharded", "uidrange"])
def test_mesh_call_matches_one_device_and_jax(setup, kind, monkeypatch):
    import test_torch_kernels
    for op in test_torch_kernels.EXP_LOG:
        monkeypatch.setitem(test_torch_kernels.FP_FLOOR, op, 0.999)
    row_ops, out = _run_mesh(setup, kind)
    _agree(f"mesh {kind}", row_ops, setup["jax"][kind], out)


def test_uidrange_rebuilds_signed_zeros(setup):
    """The uid-range call rebuilds operand rows by selection: a -0.0 in
    the cache reaches the kernel as -0.0 (a sum of picks would make it
    +0.0), so the rows equal one launch over the whole cache."""
    from pde_engine_tpu_torch.parallel.incremental import pick_rows
    mesh = CandidateMesh(["cpu"] * SHARDS)
    cache = _mesh_cache(setup, mesh, True)
    uids = torch.tensor([0, C - 1, C // SHARDS, 17, C // SHARDS - 1])
    cache.scatter(uids[:1], -torch.zeros((1, cache.sdim)),
                  -torch.zeros((1, cache.fdim)))
    s, f = pick_rows(cache.parts(), uids, torch.device("cpu"))
    snap = cache.snapshot()
    assert torch.equal(s.view(torch.int32), torch.from_numpy(
        snap["screen"][uids.numpy()]).view(torch.int32))
    assert torch.equal(f.view(torch.int32), torch.from_numpy(
        snap["fp"][uids.numpy()]).view(torch.int32))
    assert bool(torch.signbit(s[0]).all())


def test_shard_ranges_split_in_order():
    assert shard_ranges(509, 4) == [(0, 128), (128, 255), (255, 382),
                                    (382, 509)]
    assert shard_ranges(3, 4) == [(0, 1), (1, 2), (2, 3), (3, 3)]
    for n, k in ((0, 3), (7, 1), (1000, 8)):
        r = shard_ranges(n, k)
        assert r[0][0] == 0 and r[-1][1] == n and len(r) == k
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))


def test_mesh_refuses_more_cards_than_the_host_has(monkeypatch):
    with pytest.raises(ValueError, match="cpu devices"):
        CandidateMesh(["cpu", "meta"])
    assert candidate_mesh(3, "cpu").devices == (torch.device("cpu"),) * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="1 card"):
        candidate_mesh(2, "cuda")


def test_wrapper_refuses_tensors_on_two_devices(setup):
    """The entry points take raw pointers and launch on the cache's
    device: a tensor on another device is refused before anything
    runs (the CPU twin included)."""
    spec = setup["spec"]
    cs = torch.from_numpy(setup["x"]["cache_s"])
    cf = torch.from_numpy(setup["x"]["cache_f"])
    sp, fp = _points(setup)
    ab = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        ce.universal(spec, cs, cf, ab, 0, sp, fp)
    with pytest.raises(ValueError, match="more than one device"):
        ce.segmented(spec, cs, cf, ab, torch.zeros(4, dtype=torch.int32),
                     sp, fp)


@pytest.mark.parametrize("sharded", [False, True])
def test_mesh_jet_cache_equals_one_device(sharded):
    """Growth (a row quantum of K), appends straddling slice boundaries,
    scattered rows, snapshots across slices and resume seeding, against a
    one-device cache fed the same rows."""
    rng = np.random.default_rng(5)
    mesh = CandidateMesh(["cpu"] * 3)
    kw = dict(n_screen=2, t_screen=3, n_fp=1, device="cpu",
              initial_capacity=10, grow_quantum=7)
    one, many = JetCache(**kw), JetCache(**kw, mesh=mesh, sharded=sharded)
    assert many.capacity % (3 if sharded else 1) == 0
    for k in (4, 5, 9, 1, 30):          # crosses 10 -> 21 -> ... capacity
        s = torch.from_numpy(rng.normal(size=(k, 6)).astype(np.float32))
        f = torch.from_numpy(rng.normal(size=(k, 3)).astype(np.float32))
        idx = torch.arange(k - 1, -1, -1)
        one.append_gathered(s, f, idx)
        many.append_gathered(s, f, idx)
        assert many.n == one.n and many.capacity % (3 if sharded else 1) == 0
    uids = np.array([3, 0, 20, 47, 8])
    rows = torch.from_numpy(rng.normal(size=(5, 6)).astype(np.float32))
    fps = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    one.scatter(uids, rows, fps)
    many.scatter(uids, rows, fps)
    for a, b in ((one.snapshot(), many.snapshot()),
                 (one.snapshot_range(5, 40), many.snapshot_range(5, 40))):
        assert all(np.array_equal(a[k], b[k]) for k in ("screen", "fp"))
    for s, f, lo in many.parts():       # every part holds its rows
        hi = min(lo + s.shape[0], many.n)
        if lo < hi:
            assert np.array_equal(s[:hi - lo].numpy(),
                                  one.snapshot()["screen"][lo:hi])
    seeded = JetCache(**kw, mesh=mesh, sharded=sharded)
    snap = one.snapshot()
    seeded.load_rows(snap["screen"], snap["fp"])
    assert seeded.n == one.n
    assert np.array_equal(seeded.snapshot()["fp"], snap["fp"])


@pytest.fixture(scope="module")
def engines():
    """Per problem: the port's one-device per-op run, its mesh runs
    (replicated and uid-range-sharded, the latter with a window of
    ``n // 2 + 1`` rows a shard), and the JAX engine on a 2-device CPU
    mesh, all to depth 3."""
    from pde_engine_tpu.models import load_problem as jax_load_problem
    from pde_engine_tpu.parallel.mesh import candidate_mesh as jax_mesh
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu.utils.config import SearchConfig as JaxConfig
    out = {}
    mesh = CandidateMesh(["cpu", "cpu"])
    for name in ("laplace", "force_free"):
        one = DiscoveryEngine(load_problem(name), SearchConfig(
            max_depth=3, use_segmented=False), device="cpu")
        one.run(3)
        n = one.enumerator.count_uniques()
        rep = DiscoveryEngine(load_problem(name), SearchConfig(max_depth=3),
                              device="cpu", mesh=mesh)
        rep.run(3)
        shd = DiscoveryEngine(load_problem(name), SearchConfig(
            max_depth=3, shard_cache=True, max_cache_rows=n // 2 + 1),
            device="cpu", mesh=mesh)
        shd.run(3)
        jx = JaxEngine(jax_load_problem(name), JaxConfig(
            max_depth=3, use_pallas=False, use_segmented=False),
            mesh=jax_mesh(2))
        jx.run(3)
        out[name] = dict(one=one, replicated=rep, shard_cache=shd, jax=jx)
    return out


def _rows(eng):
    return [(r.id, r.expression, r.signature, r.is_valid, r.depth)
            for r in eng.rows]


def _knowns(eng):
    return {r.paper_solution_name for r in eng.valid_rows
            if r.paper_solution_name}


@pytest.mark.parametrize("name", ["laplace", "force_free"])
@pytest.mark.parametrize("mode", ["replicated", "shard_cache"])
def test_mesh_engine_rows_equal_one_device(engines, name, mode):
    e = engines[name]
    eng, one = e[mode], e["one"]
    assert _rows(eng) == _rows(one)
    assert eng.cache.n == one.cache.n == one.enumerator.count_uniques()
    assert eng.cache.sharded == (mode == "shard_cache")
    lr = eng.launched_rows()
    assert lr["universal"]["rows"] == lr["universal"]["candidates"] == sum(
        s.candidates for s in eng.stats[1:])
    assert eng.dispatch_counts()["segmented"] == 0
    if mode == "shard_cache":
        # one shard's window is below the uniques; the mesh's is not
        assert eng.cache_row_limit == 2 * (one.cache.n // 2 + 1)
        assert one.cache.n > one.cache.n // 2 + 1


@pytest.mark.parametrize("name", ["laplace", "force_free"])
def test_mesh_engine_counts_match_jax_mesh(engines, name):
    e = engines[name]
    js = [(s.unique, s.valid) for s in e["jax"].stats]
    for mode in ("replicated", "shard_cache"):
        ps = [(s.unique, s.valid) for s in e[mode].stats]
        assert ps[:2] == js[:2], (mode, ps, js)
        for (pu, pv), (ju, jv) in zip(ps[2:], js[2:]):
            assert abs(pu - ju) <= D3_SPREAD * ju, (mode, pu, ju)
            assert abs(pv - jv) <= D3_SPREAD * jv, (mode, pv, jv)
        assert _knowns(e[mode]) == _knowns(e["jax"])


def test_mesh_refuses_what_it_does_not_run():
    p = load_problem("laplace")
    mesh = CandidateMesh(["cpu", "cpu"])
    with pytest.raises(ValueError, match="per-op"):
        DiscoveryEngine(p, SearchConfig(use_segmented=True), device="cpu",
                        mesh=mesh)
    with pytest.raises(ValueError, match="requires a mesh"):
        DiscoveryEngine(p, SearchConfig(shard_cache=True), device="cpu")


def test_dryrun_multichip_on_8_cpu_shards(capsys):
    from pde_engine_tpu_torch.dryrun import dryrun_multichip
    out = dryrun_multichip(8, "cpu")
    text = capsys.readouterr().out
    assert text.count("dryrun ") == 4
    assert out["tape_survivors"] == 14
    sc = out["shard_cache"]
    assert sc["uniques"] == sc["cache_rows"] == 1878
    assert sc["window_per_shard"] == 1878 // 8 + 1


def test_bench_devices_times_the_engines_stream(tmp_path, capsys,
                                                monkeypatch):
    """``bench 2 --devices 2 --device cpu``: the depth-3 stream of the
    per-op engine through the replicated mesh call, the candidates of
    the one-device bench's stream."""
    from pde_engine_tpu_torch import bench
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("PDE_BENCH_BATCH", "4096")
    lines = []
    for argv in (["2", "--devices", "2", "--device", "cpu"],
                 ["2", "--device", "cpu"]):
        assert bench.main(argv) == 0
        out = capsys.readouterr().out.splitlines()
        assert len(out) == 1, out
        lines.append(json.loads(out[0]))
    mesh, one = lines
    assert mesh["metric"] == "mesh_sharded_validations_per_sec"
    assert mesh["value"] > 0
    d = mesh["detail"]
    assert d["devices"] == ["cpu", "cpu"] and d["depth_timed"] == 3
    assert d["candidates_timed"] == one["detail"]["candidates_timed"] == 9965
    assert d["cache_rows"] == 5 + 153
