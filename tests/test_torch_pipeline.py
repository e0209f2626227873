"""The port's discovery path against the JAX package's, end to end on the
CPU.

Per-depth counts cannot be bit-equal across backends: a fingerprint value
within an ulp of a quantization-cell edge lands in another cell when exp,
log or an FMA rounds differently, and the JAX package itself spreads
(force_free depth 3: 8,977 uniques / 2,152 valid on its XLA universal
path, 8,980 / 2,152 on its Pallas kernel in interpret mode, 8,974 / 2,155
on the TPU).  The port is held to: equal depth-1/2 counts, depth-3
uniques and valid within 0.2%, and the same known solutions found, on
its segmented path and on its per-op path (``use_segmented=False``), both
against the JAX engine's per-op path (``use_segmented=False``, the XLA
universal kernel on the CPU).  Each side loads its own problem.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_engine_tpu.models import load_problem as jax_load_problem
from pde_engine_tpu.utils.config import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.utils.config import SearchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D3_SPREAD = 0.002


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's default pool (one thread per
    core in each worker) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """The JAX engine's per-op path and the port's segmented and per-op
    paths, force_free to depth 3 on the CPU."""
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    jax_eng = JaxEngine(jax_load_problem("force_free"),
                        JaxSearchConfig(max_depth=3, use_segmented=False))
    jax_eng.run(3)
    out = {"jax": jax_eng}
    for name, seg in (("port", True), ("per_op", False)):
        out[name] = DiscoveryEngine(
            load_problem("force_free"),
            SearchConfig(max_depth=3, use_segmented=seg), device="cpu")
        out[name].run(3)
    return out


def _knowns(eng):
    return {r.paper_solution_name for r in eng.valid_rows
            if r.paper_solution_name}


def _assert_counts_match(jax_eng, port):
    js = [(s.unique, s.valid) for s in jax_eng.stats]
    ps = [(s.unique, s.valid) for s in port.stats]
    assert ps[:2] == js[:2] == [(5, 4), (153, 93)]
    for (pu, pv), (ju, jv) in zip(ps[2:], js[2:]):
        assert abs(pu - ju) <= D3_SPREAD * ju, (pu, ju)
        assert abs(pv - jv) <= D3_SPREAD * jv, (pv, jv)
    assert [s.candidates for s in port.stats] == \
        [s.candidates for s in jax_eng.stats]
    assert _knowns(port) == _knowns(jax_eng) == {
        "Vertical field", "X-point", "Parabolic"}
    assert port.device.type == "cpu"


def test_depth3_counts_match_jax(engines):
    port = engines["port"]
    _assert_counts_match(engines["jax"], port)
    assert port.segmented_dispatches > 0 and port.universal_dispatches == 0


def test_no_audit_depth3_recovers_recall_canaries(engines):
    """The depth-3 recall canaries (pure-rho expressions, valid at every
    depth) survive a no-audit force_free depth-3 run of the port as valid
    rows whose dedup keys map back to their own uids, with the JAX
    package's depth-3 knowns (the port of
    tests/test_recall_canary.py at depth 3)."""
    from pde_engine_tpu_torch import canary
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    eng = DiscoveryEngine(load_problem("force_free"),
                          SearchConfig(max_depth=3, audit_rejects=False),
                          device="cpu")
    eng.run(3)
    assert _knowns(eng) == _knowns(engines["jax"])
    assert not eng.rows or all(r.is_valid for r in eng.rows)
    planted = [e for e, d in canary.CANARIES if d == 3]
    assert len(planted) == 2
    for expr in planted:
        row = canary.locate(eng, expr)
        assert row is not None and row.is_valid, expr


def test_per_op_depth3_counts_match_jax(engines):
    """The per-op path (one ``universal`` launch per op batch) against
    the JAX engine's per-op path."""
    port = engines["per_op"]
    _assert_counts_match(engines["jax"], port)
    disp = port.dispatch_counts()
    assert disp["universal"] > 0
    assert disp["segmented"] == disp["structured"] == disp["tiled"] == 0


def test_per_op_launches_exactly_its_candidates(engines):
    """Each per-op ``universal`` launch holds exactly its candidates (no
    pad to 8,192 rows or ``batch_size``), and the counts are the port's
    depth-3 counts."""
    port = engines["per_op"]
    lr = port.launched_rows()
    assert lr["universal"]["rows"] == lr["universal"]["candidates"]
    assert lr["universal"]["candidates"] == sum(
        s.candidates for s in port.stats[1:])
    assert all(lr[k]["rows"] == 0 for k in ("segmented", "structured",
                                            "tiled"))
    assert [(s.unique, s.valid) for s in port.stats] == \
        [(5, 4), (153, 93), (8976, 2153)]


def test_jax_snapshot_round_trip_and_superbatch(engines):
    """The JAX cache loads bit for bit; one depth-3 superbatch screened
    from it by segmented_ref matches the JAX segmented kernel's packed
    words: hashes and flags on at least 99.9% of rows, rel_max above the
    float32 roundoff floor."""
    import jax.numpy as jnp

    from pde_engine_tpu.parallel.incremental import OP_INDEX
    from pde_engine_tpu.parallel.pallas_engine import (
        make_pallas_segmented_kernel)
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel.incremental import JetCache
    jax_eng, port = engines["jax"], engines["port"]
    snap = jax_eng.cache.snapshot()
    cache = JetCache.from_jax_snapshot(snap, torch.device("cpu"), 8, 15, 6)
    assert cache.n == snap["n"]
    back = cache.snapshot()
    for k in ("screen", "fp"):
        assert np.array_equal(back[k].view(np.uint32),
                              snap[k].view(np.uint32))

    N, TILE = 9216, 512
    ab = np.zeros((N, 2), np.int32)
    tile_ops = np.zeros(N // TILE, np.int32)
    fill = 0
    # mixed superbatch of the first depth-3 candidates, one op per tile
    n_parents = jax_eng.stats[0].unique + jax_eng.stats[1].unique
    gen = jax_eng.enumerator.vector_batches_at_depth(
        3, N, max_parent_uid=n_parents)
    real = []
    for op_name, a_u, b_u in gen:
        if fill == N // TILE:
            break
        take = min(a_u.size, (N // TILE - fill) * TILE)
        s = fill * TILE
        ab[s:s + take, 0] = a_u[:take]
        if b_u is not None:
            ab[s:s + take, 1] = b_u[:take]
        used = -(-take // TILE)
        tile_ops[fill:fill + used] = OP_INDEX[op_name]
        real.extend(range(s, s + take))
        fill += used
    p = jax_eng.problem
    kern = make_pallas_segmented_kernel(
        4, p.get_residual_key(), float(p.screen_rtol), 8, 6, interpret=True)
    j_p, _, _ = kern(jnp.asarray(jax_eng.cache.screen),
                     jnp.asarray(jax_eng.cache.fp), jnp.asarray(ab),
                     jnp.asarray(tile_ops),
                     jnp.asarray(p.screen_points, jnp.float32),
                     jnp.asarray(p.fingerprint_points, jnp.float32))
    spec = port._spec
    t_p, _, _ = ce.segmented(
        spec, cache.screen, cache.fp, torch.from_numpy(ab),
        torch.from_numpy(np.repeat(tile_ops, TILE)),
        torch.as_tensor(p.screen_points, dtype=torch.float32), None)
    j = np.asarray(j_p)[real]
    t = t_p.numpy().view(np.uint32)[real]
    assert len(real) > 2000
    # fingerprint hashes and the four flags: bit-equal on >= 99.9% rows
    same = ((j[:, :2] == t[:, :2]).all(axis=1)
            & ((j[:, 2] & 0xF) == (t[:, 2] & 0xF)))
    assert same.mean() >= 0.999
    # rel_max (bf16): most of these candidates are exact solutions whose
    # relative residual is float32 roundoff noise (up to ~1e-4 where the
    # scale is small), which an FMA on XLA:CPU changes.  Above the noise
    # the values agree to the bf16 rounding of the packing.
    rel_j = (j[:, 2] & 0xFFFF0000).view(np.float32).astype(np.float64)
    rel_t = (t[:, 2] & 0xFFFF0000).view(np.float32).astype(np.float64)
    assert (np.isfinite(rel_j) == np.isfinite(rel_t)).mean() >= 0.999
    loud = (np.isfinite(rel_j) & np.isfinite(rel_t)
            & (np.maximum(rel_j, rel_t) > 1e-3))
    assert loud.sum() > 500
    close = (np.abs(rel_j[loud] - rel_t[loud])
             <= 2 ** -7 * np.abs(rel_j[loud]))
    assert close.mean() >= 0.999


@pytest.mark.parametrize("expr", [
    "rho**2*z", "sqrt(rho**2 + z**2) - z", "rho*z", "(z*(rho/z))/rho",
    "exp(-40*(1 - rho)*exp(z**2))"])
def test_recheck_f64_matches_jax(engines, expr):
    """The float64 recheck (oracle + informative points + constant
    guard) gives the JAX engine's verdict and relative residual."""
    from pde_engine_tpu.enumerator import Candidate as JaxCandidate
    from pde_engine_tpu_torch.enumerator import Candidate
    jax_eng, port = engines["jax"], engines["port"]

    def cand(eng, cls):
        p = eng.problem  # parse interns constants into its own table
        return cls(depth=3, expr_str=expr, top_op="", has_var=True,
                   tape=p.parse(expr), consts=p.consts)
    ok, rel = port._recheck_f64(cand(port, Candidate))
    ok_j, rel_j = jax_eng._recheck_f64(cand(jax_eng, JaxCandidate))
    assert ok == ok_j
    assert rel == rel_j or (np.isinf(rel) and np.isinf(rel_j))


@pytest.fixture(scope="module")
def laplace_mixed():
    """Laplace to depth 4 at ``batch_size=512`` with every run item in
    the mixed (segmented) buffers: no structured carve, no tiled bypass."""
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    eng = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=4, use_segmented=True, use_structured=False,
        use_tiled=False, batch_size=512), device="cpu")
    eng.run(4)
    assert eng.structured_dispatches == eng.tiled_dispatches == 0
    return eng


def test_structured_pipeline_matches_mixed(laplace_mixed):
    """The port of ``tests/test_structured.py::
    test_structured_pipeline_matches_mixed``: with the full-run carve on
    (the tiled bypass off) only whole superbatches are carved, so the
    rows, their ids and their order equal the mixed path's; at one tile a
    superbatch, depth 4's parent runs are carved."""
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    ref = laplace_mixed
    eng = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=4, use_segmented=True, use_structured=True,
        use_tiled=False, batch_size=512), device="cpu")
    eng.run(4)
    assert eng.structured_dispatches > 0 and eng.tiled_dispatches == 0
    assert [(s.candidates, s.unique, s.valid) for s in ref.stats] == \
        [(s.candidates, s.unique, s.valid) for s in eng.stats]
    assert [(r.id, r.expression, r.signature, r.is_valid)
            for r in ref.rows] == \
        [(r.id, r.expression, r.signature, r.is_valid) for r in eng.rows]


def test_tiled_pipeline_matches_mixed(laplace_mixed):
    """The port of ``tests/test_structured.py::
    test_tiled_pipeline_matches_mixed``: with the tiled bypass, short runs
    go through the tiled kernel and the three buffers interleave, so uids
    follow another order; the candidate set and the order-invariant
    fingerprint dedup give equal counts per depth and the same knowns."""
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    ref = laplace_mixed
    eng = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=4, use_segmented=True, use_structured=True,
        use_tiled=True, batch_size=512, tiled_min_rows=64), device="cpu")
    eng.run(4)
    assert eng.tiled_dispatches > 0
    assert [(s.candidates, s.unique, s.valid) for s in ref.stats] == \
        [(s.candidates, s.unique, s.valid) for s in eng.stats]
    k1 = {r.paper_solution_name for r in ref.rows if r.is_paper_solution}
    k2 = {r.paper_solution_name for r in eng.rows if r.is_paper_solution}
    assert k1 == k2 and len(k2) > 0


def test_jet_cache_grow_clamped_to_row_limit():
    """Growth never allocates past the row budget (rounded up to the grow
    quantum), an oversized physical append still fits, and appended rows
    read back in order (the JAX package's test, on torch tensors)."""
    from pde_engine_tpu_torch.parallel.incremental import JetCache
    cpu = torch.device("cpu")
    c = JetCache(2, 3, 2, cpu, initial_capacity=8, grow_quantum=8)
    c.row_limit = 20
    for i in range(5):
        c.append(torch.full((8, c.sdim), float(i)),
                 torch.full((8, c.fdim), float(i)),
                 real_rows=min(8, max(0, c.row_limit - c.n)))
        if c.n >= c.row_limit:
            break
    assert c.capacity <= 24 and c.n == 20
    part = c.snapshot_range(8, 30)
    assert part["screen"].shape == (12, 6)
    assert (part["screen"][:8] == 1.0).all() and (part["fp"][8:] == 2.0).all()
    c2 = JetCache(2, 3, 2, cpu, initial_capacity=8, grow_quantum=8)
    c2.row_limit = 4
    c2.append(torch.ones((16, c2.sdim)), torch.ones((16, c2.fdim)),
              real_rows=4)
    assert c2.capacity >= 16 and c2.n == 4


def test_cli_run_reads_back_through_jax_package(tmp_path, capsys):
    """A fresh port CLI run writes a run DB that the JAX package's RunDB
    and report read back."""
    from pde_engine_tpu.cli import main as jax_main
    from pde_engine_tpu.utils.db import RunDB
    from pde_engine_tpu_torch.cli import main
    db = str(tmp_path / "run.db")
    assert main(["--problem", "force_free", "--max-depth", "2",
                 "--device", "cpu", "--db-path", db]) == 0
    reports = [f for f in os.listdir(tmp_path)
               if f.startswith("reproduction_")]
    assert len(reports) == 1
    with open(tmp_path / reports[0]) as f:
        rep = json.load(f)
    assert rep["device"] == "cpu"
    assert rep["dispatches"]["segmented"] > 0
    run_id = rep["run_id"]
    rdb = RunDB(db, run_id)
    assert rdb.depth_counts() == {1: {"generated": 5, "valid": 4},
                                  2: {"generated": 153, "valid": 93}}
    assert rdb.metadata()["status"] == "completed"
    rdb.close()
    capsys.readouterr()
    assert jax_main(["--print-run-id", run_id, "--db-path", db,
                     "--no-report-families"]) == 0
    out = capsys.readouterr().out
    assert "depth 2:      153 generated,     93 valid" in out
    assert "Vertical field" in out


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from pde_engine_tpu_torch.cli import main
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    with pytest.raises(RuntimeError, match="cuda"):
        DiscoveryEngine(load_problem("force_free"), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--max-depth", "1", "--device", "cuda",
              "--db-path", os.devnull])


def test_cli_rejects_flags_it_cannot_serve(tmp_path, capsys, monkeypatch):
    """The multi-device flags parse and reach the engine: ``--devices 2
    --shard-cache`` runs on a mesh of two CPU shards with a
    uid-range-sharded cache, ``--multihost --shard-registry`` in one
    process is a mesh of its one device.  What the CLI cannot serve it
    refuses, as the JAX package's does: ``--shard-cache`` without a mesh
    (exit 2), more cards than the host has (exit 2).  The audit verbs
    parse."""
    from pde_engine_tpu_torch.cli import build_parser, main
    for k in ("PDE_ENGINE_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    reports = []
    for i, flags in enumerate((["--devices", "2", "--shard-cache"],
                               ["--multihost", "--shard-registry"])):
        d = tmp_path / str(i)
        assert main(["--problem", "laplace", "--max-depth", "2", "--device",
                     "cpu", "--db-path", str(d / "run.db"),
                     "--no-report-families"] + flags) == 0
        (rep,) = d.glob("reproduction_*.json")
        reports.append(json.loads(rep.read_text()))
    mesh2, one = (r["mesh"] for r in reports)
    assert mesh2["devices"] == ["cpu", "cpu"] and mesh2["shard_cache"]
    assert one["devices"] == ["cpu"] and one["processes"] == 1
    assert one["registry_shards"] == 1 and not one["shard_cache"]
    for r in reports:
        assert r["by_depth"]["2"] == {"generated": 61, "valid": 17}
        assert r["dispatches"]["universal"] > 0
    capsys.readouterr()
    assert main(["--device", "cpu", "--shard-cache", "--db-path",
                 str(tmp_path / "x.db")]) == 2
    assert "requires a mesh" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert main(["--devices", "2", "--db-path", str(tmp_path / "y.db")]) \
        == 2
    assert "1 card" in capsys.readouterr().out
    assert not (tmp_path / "x.db").exists()
    assert not (tmp_path / "y.db").exists()
    args = build_parser().parse_args(
        ["--print-run-id", "x", "--verify-pde", "--certify", "--watch-run",
         "y", "--find-monopole", "--audit-kerr", "--heavy-validate",
         "--profile", "p", "--debug-nans", "--spill-strings"])
    assert (args.print_run_id, args.watch_run, args.spill_strings) == \
        ("x", "y", "auto")


def test_cli_run_reads_back_through_port(tmp_path, capsys):
    """A port CLI run's DB reads back through the port's own
    ``--print-run-id``, with the run's own report."""
    from pde_engine_tpu_torch.cli import main
    db = str(tmp_path / "run.db")
    assert main(["--problem", "laplace", "--max-depth", "2", "--device",
                 "cpu", "--db-path", db, "--no-report-families"]) == 0
    rep = [f for f in os.listdir(tmp_path) if f.startswith("reproduction_")]
    with open(tmp_path / rep[0]) as f:
        rep = json.load(f)
    capsys.readouterr()
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path", db,
                 "--print-run-id", rep["run_id"],
                 "--no-report-families"]) == 0
    out = capsys.readouterr().out
    assert "depth 2:       61 generated,     17 valid" in out
    assert f"run_id: {rep['run_id']}   max_depth: 2" in out


def test_cli_debug_nans_names_the_launch(tmp_path):
    """``--debug-nans`` raises at the first screen launch whose outputs
    hold a NaN (laplace depth 3 screens ``sqrt(neg(X))``), naming the
    kernel, the op and the row; without it the same run completes."""
    from pde_engine_tpu_torch.cli import main
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    args = ["--problem", "laplace", "--max-depth", "3", "--device", "cpu",
            "--no-report-families"]
    with pytest.raises(FloatingPointError,
                       match=r"segmented: NaN in the outputs of row \d+ "
                             r"of \d+ \(op \w+"):
        main(args + ["--db-path", str(tmp_path / "a.db"), "--debug-nans"])
    assert not ce._DEBUG_NANS[0]
    assert main(args + ["--db-path", str(tmp_path / "b.db")]) == 0


def test_cli_profile_and_spill_strings(tmp_path):
    """``--profile DIR`` writes a torch.profiler trace into DIR;
    ``--spill-strings`` keeps the display strings in a temp file beside
    the run DB (when the native core loads), with the same counts."""
    from pde_engine_tpu_torch.cli import main
    from pde_engine_tpu_torch.runtime import DiscoveryRun
    from pde_engine_tpu_torch.utils.native import load_core
    prof = tmp_path / "prof"
    assert main(["--problem", "laplace", "--max-depth", "2", "--device",
                 "cpu", "--db-path", str(tmp_path / "run.db"),
                 "--no-report-families", "--profile", str(prof)]) == 0
    traces = os.listdir(prof)
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(prof / traces[0]) as f:
        assert json.load(f)["traceEvents"]
    run = DiscoveryRun("laplace", SearchConfig(max_depth=2,
                                               spill_strings="auto"),
                       db_path=str(tmp_path / "s.db"), device="cpu",
                       verbose=False, report_families=False)
    assert run.config.spill_strings == str(tmp_path)
    if load_core() is not None:
        assert run.engine.enumerator.arena.spilled
    rep = run.run(2)
    run.close()
    d2 = rep["by_depth"]["2"]
    assert (d2["generated"], d2["valid"]) == (61, 17)


_NO_JAX = r"""
import importlib, pkgutil, sys
def foreign(m):
    return (m in ("jax", "jaxlib", "pde_engine_tpu")
            or m.startswith(("jax.", "jaxlib.", "pde_engine_tpu.")))
for name in [m for m in sys.modules if foreign(m)]:
    del sys.modules[name]
sys.modules["jax"] = None
sys.modules["pde_engine_tpu"] = None
import pde_engine_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(pde_engine_tpu_torch.__path__,
                                              "pde_engine_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.pipeline import DiscoveryEngine
eng = DiscoveryEngine(load_problem("force_free"), device="cpu")
stats = eng.run(2)
assert [(s.unique, s.valid) for s in stats] == [(5, 4), (153, 93)], stats
assert not any(foreign(m) for m in sys.modules if sys.modules[m] is not None)
print("NO_JAX_OK", len(mods))
"""


def test_port_runs_without_jax():
    """Every port module imports, and a force_free depth-2 engine runs on
    the port's own problem, with any import of jax or of the JAX package
    made to fail (a subprocess: conftest imports jax)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "NO_JAX_OK" in r.stdout


_FOREIGN_IMPORT = re.compile(
    r"^\s*(?:import\s+(?:jax|pde_engine_tpu)\b(?!_torch)"
    r"|from\s+(?:jax|pde_engine_tpu)(?:\.|\s)(?!_torch))", re.M)


def _port_sources():
    root = os.path.join(REPO, "pde_engine_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in sorted(files):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_jax_import_in_port_sources():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (``pde_engine_tpu.`` / ``from pde_engine_tpu ``)."""
    for path in _port_sources():
        with open(path) as f:
            src = f.read()
        hit = _FOREIGN_IMPORT.search(src)
        assert hit is None, (path, hit and hit.group(0))
        assert "import jax" not in src and "from jax" not in src, path
    for bad in ("from pde_engine_tpu.models import x",
                "    from pde_engine_tpu import load_problem",
                "import pde_engine_tpu.utils", "from jax import numpy"):
        assert _FOREIGN_IMPORT.search(bad), bad
    for good in ("from pde_engine_tpu_torch.models import x",
                 "import pde_engine_tpu_torch", "from .models import x"):
        assert not _FOREIGN_IMPORT.search(good), good


# Modules the port copies from the JAX package; the copies differ from
# their originals in docstrings and comments only (the code, imports
# included, is the same: each resolves relative imports to its own
# package).  utils/native.py is left out: its copy builds its own C++
# source into build/torch_ext/; utils/report.py too: its copy reads
# per-depth counts saved under str keys as one int key per depth
# (tests/test_torch_audits.py).
COPIED = ["ops/optable.py", "ops/jets.py", "ops/jetops.py", "ops/tape.py",
          "models/__init__.py", "models/base.py", "models/residuals.py",
          "models/force_free.py", "models/kerr.py",
          "models/kerr_small_spin.py", "models/laplace_gs.py",
          "enumerator.py", "validator.py", "utils/config.py",
          "utils/hashing.py", "utils/hostmem.py", "utils/db.py",
          "utils/certify.py", "utils/monitor.py", "utils/__init__.py",
          "ops/__init__.py"]


def _code_of(path):
    """The module's AST without docstrings (comments are not in it)."""
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(getattr(body[0], "value", None),
                               ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_code_equals_jax_package(rel):
    assert _code_of(os.path.join(REPO, "pde_engine_tpu_torch", rel)) == \
        _code_of(os.path.join(REPO, "pde_engine_tpu", rel))


def test_copied_ingest_core_code_equals_jax_package():
    """The port's copy of the C++ ingest core differs from the JAX
    package's in comments only."""
    def code(path):
        with open(path) as f:
            src = f.read()
        src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)
        src = re.sub(r"//[^\n]*", "", src)
        return [ln.strip() for ln in src.splitlines() if ln.strip()]
    assert code(os.path.join(REPO, "pde_engine_tpu_torch", "csrc",
                             "ingest_core.cpp")) == \
        code(os.path.join(REPO, "csrc", "ingest_core.cpp"))
