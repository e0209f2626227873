"""Resume of the port's runs on the CPU: registry sidecar, jet snapshot,
the rebuild from the run DB's rows when the sidecar is gone, and the
replay of composed rows through the kernels' plain twins.

Port analogs of the JAX package's resume tests (``tests/test_runtime_db.py``)
on laplace, plus the case the JAX package gets wrong: a resume without a
jet snapshot.  There the JAX package replays composed rows before it seeds
the depth-1 leaves they read (``pde_engine_tpu/pipeline.py``,
``seed_cache_from_uniques``), and on laplace 3→4 it finds 0 depth-4 valid
rows against 1,462 in a fresh run; the port seeds the leaves first and
reproduces the fresh run row for row.  Every comparison here is exact:
row ids, expressions, signatures and verdicts.
"""

import os
import sqlite3

import numpy as np
import pytest
import torch

from pde_engine_tpu_torch.parallel import cuda_engine as ce
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process: the suite runs in several
    worker processes at once, and torch's default pool (one thread per
    core in each worker) oversubscribes the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(db, depth, problem="laplace", **cfg):
    return DiscoveryRun(problem, config=SearchConfig(max_depth=depth,
                                                     **cfg),
                        db_path=str(db), device="cpu", verbose=False,
                        report_families=False)


def _resume(db, rid, depth, **cfg):
    return DiscoveryRun.resume("laplace", rid,
                               config=SearchConfig(max_depth=depth, **cfg),
                               db_path=str(db), device="cpu", verbose=False,
                               report_families=False)


def _rows(run, where=""):
    return {(int(r["id"]), r["expression"], r["signature"],
             int(r["is_valid"])) for r in run.db.rows(where)}


@pytest.mark.parametrize("use_segmented", [False, True])
def test_extension_resume_widens_final_append_window(tmp_path,
                                                     use_segmented):
    """Extending a completed run past its recorded max_depth widens the
    parent window to what a fresh run would have cached: the saved
    cache_n was clamped by the final depth's append limit.  The missing
    rows replay through the production path (per-op: ``universal``;
    segmented: tile-aligned ``segmented`` superbatches), so resumed and
    extended equals fresh."""
    small = dict(final_append_limit=10, audit_rejects=False,
                 use_segmented=use_segmented)
    fresh = _run(tmp_path / "fresh.db", 4, **small)
    frep = fresh.run(4)

    part = _run(tmp_path / "part.db", 3, **small)
    part.run(3)
    rid = part.run_id
    n_d3 = part.engine.enumerator.count_uniques()
    assert part.engine.cache.n < n_d3, \
        "test premise: the final depth must stop appending early"
    part.close()

    res = _resume(tmp_path / "part.db", rid, 4, **small)
    # window widened to every depth<=3 unique (cache_row_limit >> n here)
    assert res.engine.cache.n == n_d3
    rrep = res.continue_run(4)
    assert rrep["by_depth"] == frep["by_depth"]
    assert rrep["total_valid"] == frep["total_valid"]
    assert _rows(res, "is_valid=1") == _rows(fresh, "is_valid=1")
    fresh.close()
    res.close()


@pytest.mark.parametrize("use_segmented,depths", [(True, (3, 4)),
                                                  (False, (2, 3))])
def test_no_snapshot_resume_matches_fresh(tmp_path, use_segmented, depths):
    """Without a jet snapshot every cache row is rebuilt: leaves through
    the float64 oracle, then composed rows through the kernels.  The
    resumed run's DB equals a fresh run's row for row, reject rows
    included."""
    d0, d1 = depths
    cfg = dict(snapshot_jets=False, use_segmented=use_segmented)
    fresh = _run(tmp_path / "fresh.db", d1, **cfg)
    frep = fresh.run(d1)
    part = _run(tmp_path / "part.db", d0, **cfg)
    part.run(d0)
    rid = part.run_id
    part.close()
    assert not os.path.exists(str(tmp_path / "part.db") + ".jets.d")

    res = _resume(tmp_path / "part.db", rid, d1, **cfg)
    rrep = res.continue_run(d1)
    assert rrep["by_depth"] == frep["by_depth"]
    assert frep["by_depth"][str(d1)]["valid"] > 0
    assert _rows(res) == _rows(fresh)
    fresh.close()
    res.close()


def test_resume_replay_rows_equal_fresh_cache(tmp_path, monkeypatch):
    """The rebuilt cache equals the fresh run's rows bit for bit, and the
    per-op replay goes through ``universal`` (on the CPU its plain twin),
    one call per (depth, op) run."""
    cfg = dict(snapshot_jets=False, use_segmented=False)
    fresh = _run(tmp_path / "fresh.db", 3, **cfg)
    fresh.run(3)
    rid = fresh.run_id
    want = fresh.engine.cache.snapshot()
    fresh.close()
    calls = {"universal": 0, "segmented": 0}
    for name in calls:
        def counted(*a, _name=name, _fn=getattr(ce, name)):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(ce, name, counted)
    res = _resume(tmp_path / "fresh.db", rid, 3, **cfg)
    enum = res.engine.enumerator
    runs = {(int(enum.u_depth[u]), int(enum.u_op[u]))
            for u in range(enum.count_uniques()) if enum.u_op[u] >= 0}
    assert calls == {"universal": len(runs), "segmented": 0}
    got = res.engine.cache.snapshot()
    assert got["n"] == want["n"]
    for k in ("screen", "fp"):
        assert np.array_equal(got[k].view(np.uint32),
                              want[k].view(np.uint32))
    # seeding is not screening work (the count is the known solutions'
    # fingerprinting at engine construction)
    assert res.engine.candidates_screened == len(res.problem.known_solutions)
    assert res.engine.dispatch_counts()["universal"] == 0
    res.close()


def test_mid_depth_resume_no_duplicates(tmp_path):
    """An interrupt inside depth 2 leaves the depth-1 barrier's sidecar
    and some depth-2 rows in the DB; the resume re-runs depth 2 with the
    same uids and ids, and INSERT OR IGNORE keeps the stored rows: no
    duplicates, the fresh run's totals."""
    fresh = _run(tmp_path / "fresh.db", 2)
    frep = fresh.run(2)
    n_fresh = len(fresh.db.rows())
    fresh.close()

    part = _run(tmp_path / "part.db", 2)
    eng = part.engine
    flush = eng._flush_gray

    def interrupt(depth, st, on_row=None):
        flush(depth, st, on_row)
        if depth == 2:
            raise KeyboardInterrupt
    eng._flush_gray = interrupt
    with pytest.raises(KeyboardInterrupt):
        part.run(2)
    rid = part.run_id
    assert part.db.load_generator_state()["completed_depth"] == 1
    part.close()
    res = _resume(tmp_path / "part.db", rid, 2)
    assert res._resume_start_depth == 2
    rrep = res.continue_run(2)
    assert rrep["total_generated"] == frep["total_generated"]
    assert rrep["total_valid"] == frep["total_valid"]
    assert len(res.db.rows()) == n_fresh
    res.close()


def test_fresh_run_clears_stale_sidecar_files(tmp_path):
    """A fresh run at a db_path that carries another run's resume state
    (jet shards, registry parts and manifest, key shards) clears it
    before its own barriers write theirs."""
    db = str(tmp_path / "reuse.db")
    os.makedirs(db + ".jets.d")
    with open(os.path.join(db + ".jets.d", "shard_0_8.npz"), "wb") as f:
        np.savez(f, screen=np.ones((8, 4), np.float32),
                 fp=np.ones((8, 2), np.float32))
    os.makedirs(db + ".registry.d")
    with open(os.path.join(db + ".registry.d", "part_0_9.npz"), "wb") as f:
        np.savez(f, op=np.zeros(9, np.int16), a=np.zeros(9, np.int32),
                 b=np.zeros(9, np.int32), depth=np.ones(9, np.int16),
                 keys=np.arange(9, dtype=np.uint64),
                 run_id=np.str_("paper_repro_old_deadbeef"))
    with open(db + ".registry.npz", "wb") as f:
        np.savez(f, n_uniques=np.int64(9),
                 run_id=np.str_("paper_repro_old_deadbeef"),
                 d1_exprs=np.array(["X"]), completed_depth=np.int64(3),
                 cache_n=np.int64(9), n_rows=np.int64(9),
                 keys_sharded=np.int64(0))
    with open(db + ".registry.keys.0.npz", "wb") as f:
        np.savez(f, keys=np.arange(4, dtype=np.uint64),
                 uids=np.arange(4, dtype=np.int64), world=np.int64(4),
                 run_id=np.str_("paper_repro_old_deadbeef"))

    run = _run(db, 2)
    run.run(2)
    assert not os.path.exists(db + ".registry.keys.0.npz")
    with np.load(db + ".registry.npz") as z:
        assert str(z["run_id"]) == run.run_id
    for _, _, p in run._registry_part_files():
        with np.load(p) as z:
            assert str(z["run_id"]) == run.run_id
    shards = run._shard_files()
    assert shards and shards[0][0] == 0
    assert shards[-1][1] == run.engine.cache.n
    run.close()


def test_resume_with_corrupt_jet_shard_invalidates_snapshot(tmp_path):
    """A resume that cannot load the jet snapshot (a corrupt shard)
    removes the stale shards, rebuilds the cache through the kernels, and
    later barriers rewrite the snapshot from row 0 of the live cache."""
    db = str(tmp_path / "corrupt.db")
    run = _run(db, 2)
    run.run(2)
    rid = run.run_id
    shards = run._shard_files()
    assert shards
    run.close()
    with open(shards[0][2], "wb") as f:
        f.write(b"not an npz")

    res = _resume(db, rid, 3)
    res.continue_run(3)
    shards2 = res._shard_files()
    assert shards2 and shards2[0][0] == 0
    snap = res._load_jet_snapshot()
    assert snap is not None
    assert snap["n"] == shards2[-1][1]
    np.testing.assert_array_equal(
        snap["screen"][:snap["n"]],
        res.engine.cache.screen[:snap["n"]].numpy())
    res.close()


def test_resume_without_sidecar_raises(tmp_path):
    """A run recorded without reject rows and without a registry sidecar
    for its completed depth is refused: its DB holds only the valid
    rows, so a rebuild from it would under-enumerate every deeper
    depth."""
    db = str(tmp_path / "plain.db")
    run = _run(db, 2, audit_rejects=False)
    run.run(2)
    rid = run.run_id
    run.close()
    os.remove(db + ".registry.npz")
    with pytest.raises(RuntimeError, match="only the valid rows"):
        _resume(db, rid, 3, audit_rejects=False)


def _columns_of(rows):
    """``runtime._struct_columns`` of stored rows."""
    from pde_engine_tpu_torch.runtime import _struct_columns
    return _struct_columns(
        rows, np.array([r["depth"] for r in rows], np.int64))


def _drop_sidecar(db):
    import shutil
    os.remove(db + ".registry.npz")
    shutil.rmtree(db + ".registry.d")


@pytest.mark.parametrize("snapshot_jets,use_segmented",
                         [(True, True), (False, False)])
def test_db_rebuild_resume_matches_fresh(tmp_path, capsys, snapshot_jets,
                                         use_segmented):
    """Without its registry sidecar a run is rebuilt from its DB rows: the
    structural fast path (every composed row carries its triple), then
    the cache from the jet snapshot, or without one from the float64
    oracle (leaves) and the kernels (composed rows).  Laplace 3 -> 4
    equals a fresh depth-4 run row for row, reject rows included."""
    cfg = dict(snapshot_jets=snapshot_jets, use_segmented=use_segmented)
    fresh = _run(tmp_path / "fresh.db", 4, **cfg)
    frep = fresh.run(4)
    db = str(tmp_path / "part.db")
    part = _run(db, 3, **cfg)
    part.run(3)
    rid = part.run_id
    op, _, _, spelled = _columns_of(part.db.rows())
    assert spelled == 0 and int((op >= 0).sum()) == 1874
    part.close()
    _drop_sidecar(db)
    capsys.readouterr()
    res = DiscoveryRun.resume("laplace", rid,
                              config=SearchConfig(max_depth=4, **cfg),
                              db_path=db, device="cpu", verbose=True,
                              report_families=False)
    log = capsys.readouterr().out
    assert "resume: structural fast path for 1874 composed rows" in log
    assert "from its DB rows" in log
    assert ("jet snapshot x1878" in log) == snapshot_jets
    rrep = res.continue_run(4)
    assert rrep["by_depth"] == frep["by_depth"]
    assert frep["by_depth"]["4"]["valid"] > 0
    assert _rows(res) == _rows(fresh)
    fresh.close()
    res.close()


def _registry(run):
    eng = run.engine
    enum = eng.enumerator
    n = enum.count_uniques()
    keys, uids = eng.fp_to_uid.items_arrays()
    order = np.argsort(uids)
    return dict(
        n=n, exprs=[enum.expr_str_of(u) for u in range(n)],
        keys=keys[order].tolist(), uids=uids[order].tolist(),
        depth=enum.u_depth[:n].tolist(),
        flags=[f[:n].tolist() for f in (enum.f_has_var, enum.f_is_one,
                                        enum.f_top_inv, enum.f_is_coord)],
        valid=[r.id for r in eng.valid_rows], n_rows=eng.n_rows,
        id_offset=eng.id_offset, cache_n=eng.cache.n)


def _null_struct(db, table):
    """Make a DB as old as the struct columns: every triple NULL."""
    con = sqlite3.connect(db)
    con.execute(f"UPDATE {table} SET struct_op=NULL, struct_a=NULL, "
                "struct_b=NULL")
    con.commit()
    con.close()


def test_db_rebuild_parse_path_same_registry(tmp_path, capsys):
    """A DB whose rows carry no structural triple (older DBs: the struct
    columns NULL) takes every composed row's triple from its spelling and
    rebuilds the same registry as the structural fast path: uids,
    expressions, dedup keys, depths, pruning flags and valid rows.
    Laplace's depth-3 ``sqrt(neg(X))`` makes SymPy's ``I``; it needs no
    parse, so no uid shifts (``id_offset`` 0)."""
    import shutil
    cfg = dict(snapshot_jets=False)
    db = str(tmp_path / "a.db")
    part = _run(db, 3, **cfg)
    part.run(3)
    rid, table = part.run_id, part.db.table
    part.close()
    _drop_sidecar(db)
    nulls = str(tmp_path / "b.db")
    shutil.copy(db, nulls)
    _null_struct(nulls, table)
    regs = []
    for path, what in ((db, "resume: structural fast path for 1874 "),
                       (nulls, "resume: parse path: 1874 composed rows "
                        "re-registered from their spelling, 0 as leaves")):
        capsys.readouterr()
        res = DiscoveryRun.resume("laplace", rid,
                                  config=SearchConfig(max_depth=4, **cfg),
                                  db_path=path, device="cpu", verbose=True,
                                  report_families=False)
        assert what in capsys.readouterr().out
        regs.append(_registry(res))
        res.close()
    fast, parsed = regs
    assert parsed == fast
    assert fast["n"] == 1878 and fast["id_offset"] == 0


@pytest.mark.parametrize("problem,d0,use_segmented,tamper", [
    ("laplace", 3, True, False), ("laplace", 3, False, False),
    ("force_free", 2, True, False), ("force_free", 2, False, False),
    ("laplace", 2, True, True)])
def test_parse_path_resume_equals_fresh(tmp_path, capsys, problem, d0,
                                        use_segmented, tamper):
    """A DB as old as the struct columns (every triple NULL), without its
    registry sidecar and without a jet snapshot, resumes one depth
    deeper with a fresh run's rows, row for row (id, expression,
    signature, verdict): every composed row re-registers from its
    spelling, and the cache replays it through the kernels of the run's
    own routing (on the CPU their plain twins), as the fresh run
    computed it.  Tampered, one composed row of the last stored depth no
    longer inverts: it re-parses as a leaf (its cache row from the
    float64 oracle) and no uid shifts."""
    cfg = dict(snapshot_jets=False, use_segmented=use_segmented)
    d1 = d0 + 1
    fresh = _run(tmp_path / "fresh.db", d1, problem, **cfg)
    frep = fresh.run(d1)
    db = str(tmp_path / "part.db")
    part = _run(db, d0, problem, **cfg)
    part.run(d0)
    rid, table = part.run_id, part.db.table
    part.close()
    _drop_sidecar(db)
    assert not os.path.exists(db + ".jets.d")
    _null_struct(db, table)
    con = sqlite3.connect(db)
    stored = con.execute(f"SELECT id, expression FROM {table} WHERE "
                         "depth = ? ORDER BY id", (d0,)).fetchall()
    n_composed = con.execute(f"SELECT COUNT(*) FROM {table} WHERE "
                             "depth > 1").fetchone()[0]
    n_stored = con.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]
    if tamper:
        # "1*" + an operand: SymPy parses it, no op spells it
        tid, texpr = stored[len(stored) // 2]
        con.execute(f"UPDATE {table} SET expression=? WHERE id=?",
                    ("1*" + texpr, tid))
        con.commit()
    con.close()
    capsys.readouterr()
    res = DiscoveryRun.resume(problem, rid,
                              config=SearchConfig(max_depth=d1, **cfg),
                              db_path=db, device="cpu", verbose=True,
                              report_families=False)
    log = capsys.readouterr().out
    eng = res.engine
    enum = eng.enumerator
    registered, id_offset = enum.count_uniques(), eng.id_offset
    leaves = [u for u in range(n_stored)
              if enum.u_op[u] < 0 and enum.u_depth[u] > 1]
    rrep = res.continue_run(d1)
    if not tamper:
        # first the measure of a miss: counts and keys of the new depth
        fk, rk = ({r[2] for r in _rows(run, f"depth = {d1}")}
                  for run in (fresh, res))
        assert rrep["by_depth"] == frep["by_depth"] and fk == rk, (
            f"depth {d1}: resumed {rrep['by_depth'][str(d1)]} against "
            f"fresh {frep['by_depth'][str(d1)]}; {len(fk - rk)} of the "
            f"fresh run's keys missing, {len(rk - fk)} keys it lacks")
    m = int(tamper)
    assert (f"resume: parse path: {n_composed - m} composed rows "
            f"re-registered from their spelling, {m} as leaves") in log
    assert registered == n_stored and id_offset == 0
    if tamper:
        assert leaves == [tid - 1]
        assert enum.expr_str_of(tid - 1) == "1*" + texpr
        # the resumed depth's ids follow the stored rows, as fresh
        ids = [r[0] for r in _rows(res, f"depth = {d1}")]
        assert min(ids) == n_stored + 1
        assert max(ids) == n_stored + len(ids)
    else:
        assert leaves == []
        assert frep["by_depth"][str(d1)]["valid"] > 0
        assert _rows(res) == _rows(fresh)
    fresh.close()
    res.close()


def test_db_rebuild_loses_an_unparseable_row(tmp_path, capsys):
    """A stored composed row that neither its columns nor its spelling
    nor SymPy can rebuild is lost: its id gap shows in ``id_offset``,
    the rows whose stored triples name it re-parse as leaves, and every
    other row keeps its triple under the shifted uids."""
    from pde_engine_tpu_torch.models import load_problem
    db = str(tmp_path / "a.db")
    part = _run(db, 3, snapshot_jets=False)
    part.run(3)
    rid, table = part.run_id, part.db.table
    part.close()
    _drop_sidecar(db)
    con = sqlite3.connect(db)
    parse = load_problem("laplace").parse

    def children_of(uid):
        return con.execute(f"SELECT id, expression FROM {table} WHERE "
                           "struct_a = ? OR struct_b = ?",
                           (uid, uid)).fetchall()

    def parses(expr):
        try:
            parse(expr)
        except Exception:   # noqa: BLE001 - any SymPy failure
            return False
        return True
    # a depth-2 row whose children all re-parse without it
    uid, children = next(
        (u, c) for u, in con.execute(f"SELECT id - 1 FROM {table} WHERE "
                                     "depth = 2 ORDER BY id")
        for c in [children_of(u)] if c and all(parses(e) for _, e in c))
    n = con.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]
    con.execute(f"UPDATE {table} SET expression='((', struct_op=NULL, "
                "struct_a=NULL, struct_b=NULL WHERE id=?", (uid + 1,))
    con.commit()
    con.close()
    capsys.readouterr()
    res = DiscoveryRun.resume("laplace", rid,
                              config=SearchConfig(max_depth=4,
                                                  snapshot_jets=False),
                              db_path=db, device="cpu", verbose=True,
                              report_families=False)
    assert ("resume: parse path: 0 composed rows re-registered from "
            f"their spelling, {len(children)} as leaves, 1 rows lost"
            in capsys.readouterr().out)
    enum = res.engine.enumerator
    assert enum.count_uniques() == n - 1 and res.engine.id_offset == 1
    # each row after the lost one sits one uid lower
    leaves = [u for u in range(n - 1)
              if enum.u_op[u] < 0 and enum.u_depth[u] > 1]
    assert leaves == [i - 2 for i, _ in children]
    assert enum.expr_str_of(n - 2) == res.db.rows("id = ?", (n,))[0][
        "expression"]
    res.close()


def _misspelled(enum):
    """The composed uniques of ``enum`` with a triple whose parents do
    not spell them as the forward path does."""
    from pde_engine_tpu_torch.enumerator import wrap_operand
    from pde_engine_tpu_torch.ops import optable as ot
    names = list(ot.ALL_SURFACE_OPS)
    es = [enum.expr_str_of(u) for u in range(enum.count_uniques())]
    out = []
    for u in np.flatnonzero(enum.u_op[:len(es)] >= 0).tolist():
        name = names[int(enum.u_op[u])]
        a, b = int(enum.u_a[u]), int(enum.u_b[u])
        if b < 0:
            s = f"{name}({es[a]})"
        elif name in ot.SURFACE_FORMAT:
            s = ot.SURFACE_FORMAT[name].format(a=wrap_operand(es[a]),
                                               b=wrap_operand(es[b]))
        else:
            s = f"{name}({es[a]}, {es[b]})"
        if s != es[u]:
            out.append(u)
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_second_resume_after_a_lost_row(tmp_path, capsys, writer):
    """A resume that could not re-register a stored row writes the next
    depth's struct columns in uids shifted past that row.  The port: a
    depth-2 row that nothing rebuilds, lost again by the next resume.
    The JAX package: its parse path drops a row SymPy cannot parse, here
    a depth-2 row made so for its resume and restored after it, so that
    the port keeps it (the JAX package's own losses, laplace's depth-3
    ``sqrt(neg(X))``, appear only in a depth-4 run).  The next resume
    takes a stored triple only where its parents spell the row: its
    registry and its depth 4 equal those of a resume of the same DB with
    every struct column NULL, and every composed unique is spelled by
    its parents."""
    import shutil
    db = str(tmp_path / "run.db")
    if writer == "port":
        part = _run(db, 2, snapshot_jets=False)
    else:
        from pde_engine_tpu.runtime import DiscoveryRun as JaxRun
        from pde_engine_tpu.utils.config import SearchConfig as JaxConfig
        part = JaxRun("laplace", config=JaxConfig(max_depth=2),
                      db_path=db, verbose=False)
    part.run(2)
    rid, table = part.run_id, part.db.table
    part.close()

    def drop_sidecars():
        for f in (".registry.npz", ".registry.d", ".jets.d"):
            if os.path.isdir(db + f):
                shutil.rmtree(db + f)
            elif os.path.exists(db + f):
                os.remove(db + f)
    drop_sidecars()
    con = sqlite3.connect(db)
    tid, texpr = con.execute(f"SELECT id, expression FROM {table} WHERE "
                             "depth = 2 ORDER BY id LIMIT 1 OFFSET 5"
                             ).fetchone()
    con.execute(f"UPDATE {table} SET expression='((', struct_op=NULL, "
                "struct_a=NULL, struct_b=NULL WHERE id=?", (tid,))
    con.commit()
    con.close()
    if writer == "port":
        first = _resume(db, rid, 3, snapshot_jets=False)
    else:
        first = JaxRun.resume("laplace", rid,
                              config=JaxConfig(max_depth=3), db_path=db,
                              verbose=False)
    assert first.engine.id_offset == 1
    first.continue_run(3)
    first.close()
    drop_sidecars()
    con = sqlite3.connect(db)
    if writer == "jax":
        con.execute(f"UPDATE {table} SET expression=? WHERE id=?",
                    (texpr, tid))
        con.commit()
    # the first resume's depth 3 names parents past the row by shifted uids
    assert con.execute(f"SELECT COUNT(*) FROM {table} WHERE depth = 3 AND "
                       "struct_a >= ?", (tid - 1,)).fetchone()[0] > 0
    con.close()
    nulls = str(tmp_path / "nulls.db")
    shutil.copy(db, nulls)
    _null_struct(nulls, table)
    out = []
    for path in (db, nulls):
        capsys.readouterr()
        res = DiscoveryRun.resume("laplace", rid,
                                  config=SearchConfig(max_depth=4,
                                                      snapshot_jets=False),
                                  db_path=path, device="cpu", verbose=True,
                                  report_families=False)
        assert "resume: parse path: " in capsys.readouterr().out
        enum = res.engine.enumerator
        n = enum.count_uniques()
        reg = _registry(res)
        reg.update(op=enum.u_op[:n].tolist(), a=enum.u_a[:n].tolist(),
                   b=enum.u_b[:n].tolist())
        assert _misspelled(enum) == []
        assert reg["id_offset"] == int(writer == "port")
        res.continue_run(4)
        out.append((reg, _rows(res)))
        res.close()
    (reg, rows), (null_reg, null_rows) = out
    assert reg == null_reg
    assert rows == null_rows


def test_struct_columns_from_spelling_hazards():
    """The triples a row's spelling gives, over the rows before it:
    infix formats over wrapped operands (a depth-1 ``1 - x`` is
    ``(1 - x)`` there, bare inside a unary op), commas inside an
    operand, a spelling that two rows share (the first one names it),
    and the stored columns, taken where the rows at their positions
    spell the row (a resume that lost a row writes shifted uids there).
    A row that no spelling inverts is a leaf (op -1)."""
    from pde_engine_tpu_torch.ops import optable as ot
    names = list(ot.ALL_SURFACE_OPS)
    binary = next(n for n in names if n not in ot.UNARY_OPS
                  and n not in ot.SURFACE_FORMAT)
    nested = f"{binary}(inv(x), {binary}(x, y))"
    spellings = [
        ("x", 1), ("y", 1), ("1 - x", 1),
        ("inv(x)", 2), ("inv(x)", 2),           # 3, 4: one spelling
        (f"{binary}(x, y)", 2), ("inv(1 - x)", 2),
        (nested, 3),                            # 7: a comma inside b
        ("((1 - x) * inv(1 - x))", 3),          # 8: wrapped and raw
        ("(inv(x) + (x + 1))", 3),              # 9: no such operand
        ("1*inv(x)", 3)]                        # 10: no such op
    rows = [dict(id=i + 1, expression=e, depth=d, struct_op=None,
                 struct_a=None, struct_b=None)
            for i, (e, d) in enumerate(spellings)]
    op, a, b, spelled = _columns_of(rows)
    inv, bi = names.index("inv"), names.index(binary)
    assert op.tolist() == [-1, -1, -1, inv, inv, bi, inv, bi,
                           names.index("mul"), -1, -1]
    assert a.tolist() == [-1, -1, -1, 0, 0, 0, 2, 3, 2, -1, -1]
    assert b.tolist() == [-1, -1, -1, -1, -1, 1, -1, 5, 6, -1, -1]
    assert spelled == 6
    # stored columns are taken where they spell the row: over a spelling
    # two rows share, and over a wrapped depth-1 operand
    mul = names.index("mul")
    rows[7].update(struct_op=bi, struct_a=4, struct_b=5)
    rows[8].update(struct_op=mul, struct_a=2, struct_b=6)
    op, a, b, spelled = _columns_of(rows)
    assert (op[7], a[7], b[7], spelled) == (bi, 4, 5, 4)
    assert (op[8], a[8], b[8]) == (mul, 2, 6)
    # uids shifted by one (the writer lost a row) spell another row, and
    # so does a triple that names a later row or an unknown op
    rows[7].update(struct_a=5, struct_b=6)
    rows[8].update(struct_a=2, struct_b=9)
    rows[9].update(struct_op=len(names), struct_a=3, struct_b=1)
    op, a, b, spelled = _columns_of(rows)
    assert (op[7], a[7], b[7]) == (bi, 3, 5)
    assert (op[8], a[8], b[8]) == (mul, 2, 6)
    assert (op[9], a[9], b[9], spelled) == (-1, -1, -1, 6)


def _indices(db, table):
    """The run table's secondary indices in the file, read through a
    connection of their own."""
    con = sqlite3.connect(db)
    names = {r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='index' AND "
        "tbl_name=? AND name LIKE 'idx_%'", (table,))}
    con.close()
    return names


def _made_indices(tmp_path, rid, table):
    """The secondary indices ``RunDB.ensure_indices`` builds on a new
    file of the run."""
    from pde_engine_tpu_torch.utils.db import RunDB
    path = str(tmp_path / "indices.db")
    db = RunDB(path, rid)
    db.ensure_indices()
    db.close()
    return _indices(path, table)


@pytest.mark.parametrize("rebuild", ["sidecar", "db"])
def test_resumed_depth_written_without_secondary_indices(tmp_path,
                                                          rebuild):
    """A resumed depth is written as a fresh one is: without the four
    secondary indices its reopened file holds, which the completion
    builds once.  A resume cut inside the depth leaves a file without
    them, and its first ``RunDB.rows`` builds them.  On the registry
    sidecar and on the DB rebuild, the resumed rows equal a fresh run's
    row for row."""
    from pde_engine_tpu_torch.utils.db import RunDB
    fresh = _run(tmp_path / "fresh.db", 3)
    fresh.run(3)
    db = str(tmp_path / "part.db")
    part = _run(db, 2)
    part.run(2)
    rid, table = part.run_id, part.db.table
    part.close()
    made = _made_indices(tmp_path, rid, table)
    assert len(made) == 4 and _indices(db, table) == made
    if rebuild == "db":
        _drop_sidecar(db)

    cut = _resume(db, rid, 3)
    eng = cut.engine
    flush = eng._flush_gray

    def killed(depth, st, on_row=None):
        flush(depth, st, on_row)
        raise RuntimeError("cut")
    eng._flush_gray = killed
    with pytest.raises(RuntimeError, match="cut"):
        cut.continue_run(3)
    cut.close()
    assert _indices(db, table) == set()
    con = sqlite3.connect(db)
    assert con.execute(f"SELECT COUNT(*) FROM {table} WHERE depth = 3"
                       ).fetchone()[0] > 0
    con.close()
    reader = RunDB(db, rid)
    reader.rows("depth = 1")
    reader.close()
    assert _indices(db, table) == made

    res = _resume(db, rid, 3)
    seen = []
    save = res.db.save_generator_state

    def at_barrier(state):
        seen.append((state["completed_depth"], _indices(db, table)))
        save(state)
    res.db.save_generator_state = at_barrier
    res.continue_run(3)
    assert seen == [(3, set())]
    assert _indices(db, table) == made
    assert _rows(res) == _rows(fresh)
    fresh.close()
    res.close()


@pytest.mark.parametrize("rebuild", ["sidecar", "db"])
def test_non_writer_resume_keeps_secondary_indices(tmp_path, monkeypatch,
                                                   rebuild):
    """A rank that does not write the run (rank > 0 of ``--multihost``)
    rebuilds it through its read-only view and leaves the file's
    secondary indices to the writer."""
    from pde_engine_tpu_torch.utils.db import ReadOnlyRunDB
    db = str(tmp_path / "run.db")
    part = _run(db, 2)
    part.run(2)
    rid, table = part.run_id, part.db.table
    part.close()
    made = _indices(db, table)
    assert made == _made_indices(tmp_path, rid, table)
    if rebuild == "db":
        _drop_sidecar(db)
    init = DiscoveryRun.__init__

    def non_writer(self, *a, **kw):
        init(self, *a, **kw)
        if self._native_sink is not None:
            self._native_sink.close()
            self._native_sink = self.engine.native_sink = None
        self.db.close()
        self.is_writer = False
        self.db = ReadOnlyRunDB(self.db_path, self.run_id)
    monkeypatch.setattr(DiscoveryRun, "__init__", non_writer)
    res = _resume(db, rid, 3)
    assert not res.is_writer
    assert res.engine.enumerator.count_uniques() == 65
    assert _indices(db, table) == made
    res.close()


def test_triple_of_spelling_inverts_the_forward_spelling(tmp_path):
    """Every composed unique of a laplace depth-3 run: its spelling, over
    the spellings of the uniques before it, names its op and parents."""
    from pde_engine_tpu_torch.enumerator import wrap_operand
    from pde_engine_tpu_torch.runtime import _triple_of_spelling
    run = _run(tmp_path / "x.db", 3)
    run.run(3)
    enum = run.engine.enumerator
    names = enum._op_names
    raw, wrapped = {}, {}
    for u in range(enum.count_uniques()):
        s = enum.expr_str_of(u)
        if enum.u_op[u] >= 0:
            b = int(enum.u_b[u])
            assert _triple_of_spelling(s, raw, wrapped) == (
                names[int(enum.u_op[u])], int(enum.u_a[u]),
                None if b < 0 else b), s
        raw.setdefault(s, u)
        wrapped.setdefault(wrap_operand(s), u)
    assert _triple_of_spelling("nope(X)", raw, wrapped) is None
    run.close()


def test_cli_resume_extends_run(tmp_path, capsys):
    """``--resume-run <id> --max-depth 3`` extends a CLI depth-2 run; its
    rows equal a fresh CLI depth-3 run's, and the JAX package's
    ``--print-run-id`` reads the resumed DB."""
    import json

    from pde_engine_tpu.cli import main as jax_main
    from pde_engine_tpu_torch.cli import main

    def cli(d, *extra):
        os.makedirs(d, exist_ok=True)
        db = os.path.join(d, "run.db")
        assert main(["--problem", "laplace", "--device", "cpu",
                     "--db-path", db, "--no-report-families"]
                    + list(extra)) == 0
        reps = sorted(f for f in os.listdir(d)
                      if f.startswith("reproduction_"))
        with open(os.path.join(d, reps[-1])) as f:
            return db, json.load(f)

    fdb, frep = cli(str(tmp_path / "fresh"), "--max-depth", "3")
    pdb, prep = cli(str(tmp_path / "part"), "--max-depth", "2")
    _, rrep = cli(str(tmp_path / "part"), "--resume-run", prep["run_id"],
                  "--max-depth", "3")
    assert rrep["run_id"] == prep["run_id"]
    assert rrep["by_depth"] == frep["by_depth"]
    assert rrep["dispatches"]["segmented"] > 0

    def rows(db, rid):
        import sqlite3
        con = sqlite3.connect(db)
        out = set(con.execute(
            "SELECT id, expression, signature, is_valid FROM expressions_"
            + rid.replace("-", "_")))
        con.close()
        return out
    assert rows(pdb, prep["run_id"]) == rows(fdb, frep["run_id"])
    capsys.readouterr()
    assert jax_main(["--print-run-id", prep["run_id"], "--db-path", pdb,
                     "--no-report-families"]) == 0
    assert "depth 3:" in capsys.readouterr().out


def test_cuda_resume_without_gpu_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="cuda"):
        DiscoveryRun.resume("laplace", "x", db_path=str(tmp_path / "x.db"),
                            device="cuda")


def _composed(enum, lo, total):
    """The composed uniques among [lo, total): the rows a replay of the
    cache screens."""
    return sum(1 for u in range(lo, total) if enum.u_op[u] >= 0)


def test_segmented_replay_launches_filled_tiles(tmp_path, monkeypatch):
    """With 4-tile superbatches the segmented replay of a depth-3 cache
    spans several superbatches per depth, the last one partial.  The
    launches screen exactly the composed uniques (no pad row), and the
    rebuilt cache equals the fresh run's bit for bit.  The fresh run's
    segmented launches screen exactly their candidates, its tiled
    launches exactly the 512-row tiles that hold one."""
    cfg = dict(snapshot_jets=False, use_segmented=True, batch_size=2048)
    fresh = _run(tmp_path / "fresh.db", 3, **cfg)
    fresh.run(3)
    rid = fresh.run_id
    want = fresh.engine.cache.snapshot()
    lr = fresh.engine.launched_rows()
    fresh.close()
    assert lr["segmented"]["rows"] == lr["segmented"]["candidates"] > 0
    assert lr["tiled"]["rows"] == lr["tiled"]["tile_rows"] >= \
        lr["tiled"]["candidates"]

    launches = []

    def counted(spec, cs, cf, ab, row_ops, sp, fp, _fn=ce.segmented):
        out = _fn(spec, cs, cf, ab, row_ops, sp, fp)
        launches.append(int(out[0].shape[0]))
        return out
    monkeypatch.setattr(ce, "segmented", counted)
    res = _resume(tmp_path / "fresh.db", rid, 3, **cfg)
    enum = res.engine.enumerator
    assert sum(launches) == _composed(enum, 0, enum.count_uniques())
    assert all(0 < n <= 2048 for n in launches)
    assert any(n < 2048 for n in launches)
    got = res.engine.cache.snapshot()
    assert got["n"] == want["n"]
    for k in ("screen", "fp"):
        assert np.array_equal(got[k].view(np.uint32),
                              want[k].view(np.uint32))
    res.close()


def test_partial_superbatch_resume_matches_fresh(tmp_path):
    """A no-snapshot segmented resume at 4-tile superbatches (the replay's
    last superbatch partial, launched without pad rows) extends a
    depth-2 run to depth 3 with a fresh depth-3 run's rows, row for
    row."""
    cfg = dict(snapshot_jets=False, use_segmented=True, batch_size=2048)
    fresh = _run(tmp_path / "fresh.db", 3, **cfg)
    frep = fresh.run(3)
    part = _run(tmp_path / "part.db", 2, **cfg)
    part.run(2)
    rid = part.run_id
    part.close()
    res = _resume(tmp_path / "part.db", rid, 3, **cfg)
    rrep = res.continue_run(3)
    assert rrep["by_depth"] == frep["by_depth"]
    assert _rows(res) == _rows(fresh)
    fresh.close()
    res.close()
