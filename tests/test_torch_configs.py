"""The JAX CLI's run configurations through the port, against the JAX
package on the CPU, and the resume of a run recorded under one.

- ``--no-special-ops`` (``SearchConfig(include_special_ops=False)``) and
  ``--no-prune`` (``prune=False``) are stored in a run's generator state.
  A resume builds its engine, and with it the ``Enumerator``, from the
  stored flags (``runtime.recorded_config``): laplace to depth 2 under
  either flag, resumed to depth 3 without it, from the registry sidecar
  and rebuilt from the DB rows, equals the fresh depth-3 run row for row
  (1,341 / 1,075 / 118 and 2,546 / 1,941 / 164 candidates / uniques /
  valid at depth 3).  The JAX package builds its engine from the command
  line's flags first (``pde_engine_tpu/runtime.py``, ``resume``), so it
  resumes such a run with another enumeration (1,725 / 1,407 / 122 and
  2,385 / 1,926 / 164): a fault the port does not copy, pinned here.  A resume that
  asks for a flag against a run recorded without it is refused (the CLI
  exits 2 and writes nothing); a ``--devices 1`` mesh resume takes the
  stored flags too.
- Each configuration against the JAX engine's per-op path (the XLA
  universal kernel), each side on its own problem: depths 1-2 exact,
  depth-3 uniques and valid within 0.2% (the bound
  ``tests/test_torch_pipeline.py`` states), the same candidates per depth
  and the same knowns.  ``--no-special-ops`` on force_free (both of the
  port's paths) and laplace; grad_shafranov has no special op
  (``models/laplace_gs.py``), so the flag leaves its run as it is;
  ``--no-prune`` on laplace and force_free.
- ``--mode sequential`` (``confirm_symbolic=True``: SymPy proves every
  numeric zero inline) with ``--heavy-checks`` (``defer_heavy_checks=
  False``) through both CLIs on laplace to depth 3: every row that
  reached the symbolic stage has the JAX run's signature, verdict,
  reason, validator method and heavy verdict; of the rows both runs
  hold, only float32 screen-edge rejects may differ (a reject kept by
  the screen on one side and by the float64 recheck on the other), as
  many as the depth-3 bound allows.  ``--mode sequential`` and
  ``--confirm-symbolic`` are one configuration: their runs are equal row
  for row.
"""

import hashlib
import os
import shutil
import sqlite3

import pytest
import torch

from pde_engine_tpu.models import load_problem as jax_load_problem
from pde_engine_tpu.utils.config import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.runtime import DiscoveryRun, ResumeConflict
from pde_engine_tpu_torch.utils.config import SearchConfig

D3_SPREAD = 0.002
# laplace at depth 3 under each flag: candidates, uniques, valid (the
# same in the port and in the JAX package)
FLAGS = {"include_special_ops": ("--no-special-ops", (1341, 1075, 118)),
         "prune": ("--no-prune", (2546, 1941, 164))}
SPECIAL_OPS = ("sqrt_shift_neg", "sqrt_shift_pos", "exp_mul", "log_mul")
FUNNEL_COLS = ("signature, is_valid, validation_reason, validator_method, "
               "heavy_is_valid, heavy_reason")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(db, depth, **cfg):
    return DiscoveryRun("laplace", config=SearchConfig(max_depth=depth,
                                                       **cfg),
                        db_path=str(db), device="cpu", verbose=False,
                        report_families=False)


def _rows(run):
    return {(int(r["id"]), r["expression"], r["signature"],
             int(r["is_valid"])) for r in run.db.rows()}


def _copy_run(src, dst):
    """A run DB with its sidecars, under another directory."""
    os.makedirs(dst, exist_ok=True)
    for name in os.listdir(src):
        s, d = os.path.join(src, name), os.path.join(dst, name)
        (shutil.copytree if os.path.isdir(s) else shutil.copy)(s, d)
    return os.path.join(dst, "run.db")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """Under each flag turned off: laplace fresh to depth 3 (its rows and
    by-depth counts) and a depth-2 run to resume (its directory and id)."""
    out = {}
    for key in FLAGS:
        base = tmp_path_factory.mktemp(key)
        fresh = _run(base / "fresh" / "run.db", 3, **{key: False})
        rep = fresh.run(3)
        rows = _rows(fresh)
        fresh.close()
        part = _run(base / "part" / "run.db", 2, **{key: False})
        part.run(2)
        out[key] = dict(rows=rows, by_depth=rep["by_depth"],
                        stats=[(s.candidates, s.unique, s.valid)
                               for s in fresh.engine.stats],
                        part=str(base / "part"), run_id=part.run_id)
        part.close()
    return out


@pytest.mark.parametrize("sidecar", [True, False],
                         ids=["sidecar", "db_rebuild"])
@pytest.mark.parametrize("key", list(FLAGS))
def test_resume_takes_the_recorded_flag(recorded, tmp_path, capsys, key,
                                        sidecar):
    """Laplace to depth 2 with the flag turned off, resumed to depth 3 by
    a config that leaves it on (the default, as a command line that does
    not repeat the flag): the engine enumerates with the stored setting,
    the resumed run equals the fresh depth-3 run row for row, and the
    state row of its depth 3 records the setting that was used."""
    rec = recorded[key]
    db = _copy_run(rec["part"], tmp_path / "run")
    if not sidecar:
        os.remove(db + ".registry.npz")
        shutil.rmtree(db + ".registry.d")
    capsys.readouterr()
    res = DiscoveryRun.resume("laplace", rec["run_id"],
                              config=SearchConfig(max_depth=3), db_path=db,
                              device="cpu", verbose=True,
                              report_families=False)
    log = capsys.readouterr().out
    assert ("from its DB rows" in log) != sidecar
    assert getattr(res.config, key) is False
    enum = res.engine.enumerator
    assert not enum.prune if key == "prune" else \
        not {n for n, _ in enum.binary} & set(SPECIAL_OPS)
    rep = res.continue_run(3)
    st = res.engine.stats[-1]
    assert (st.candidates, st.unique, st.valid) == FLAGS[key][1] \
        == rec["stats"][-1]
    assert rep["by_depth"] == rec["by_depth"]
    assert _rows(res) == rec["rows"]
    state = res.db.load_generator_state()
    assert state["completed_depth"] == 3 and state[key] is False
    res.close()


# the JAX package's resume of the same depth-2 runs without the flag:
# candidates, uniques, valid at depth 3, and the flag its state row records
JAX_RESUMED = {"include_special_ops": ((1725, 1407, 122), False),
               "prune": ((2385, 1926, 164), True)}


@pytest.mark.parametrize("key", list(FLAGS))
def test_jax_resume_enumerates_another_set(tmp_path, key):
    """The reference's fault, which the port does not copy: the JAX
    package builds the resumed engine from the command line's config, so
    a laplace run to depth 2 with the flag turned off, resumed to depth 3
    without it, enumerates neither the fresh run's depth 3 nor the
    default's (2,193 / 1,813 / 135), and its state row records the stored
    ``include_special_ops`` (not what enumerated) and ``prune`` on."""
    from pde_engine_tpu.runtime import DiscoveryRun as JaxRun
    db = str(tmp_path / "run.db")
    part = JaxRun("laplace", JaxSearchConfig(max_depth=2, **{key: False}),
                  db_path=db, verbose=False)
    part.run(2)
    res = JaxRun.resume("laplace", part.run_id,
                        config=JaxSearchConfig(max_depth=3), db_path=db,
                        verbose=False)
    res.continue_run(3)
    st = res.engine.stats[-1]
    counts, recorded = JAX_RESUMED[key]
    assert (st.candidates, st.unique, st.valid) == counts
    assert counts != FLAGS[key][1]
    assert res.db.load_generator_state()[key] is recorded


def _tree(d):
    """{relative path: sha256} of every file under ``d``."""
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def default_run(tmp_path_factory):
    """A default laplace run to depth 2 (special ops and pruning on)."""
    d = tmp_path_factory.mktemp("default")
    run = _run(d / "run.db", 2)
    run.run(2)
    run.close()
    return str(d), run.run_id


@pytest.mark.parametrize("key", list(FLAGS))
def test_conflicting_resume_is_refused(default_run, tmp_path, capsys, key):
    """``--resume-run`` with ``--no-special-ops`` or ``--no-prune`` on a
    run recorded with the flag on exits 2 with one line naming the stored
    setting and the flag, and writes nothing: every file of the run is as
    it was.  The library refuses the same config with ResumeConflict."""
    from pde_engine_tpu_torch.cli import main
    db = _copy_run(default_run[0], tmp_path / "run")
    before = _tree(tmp_path / "run")
    flag = FLAGS[key][0]
    capsys.readouterr()
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path", db,
                 "--resume-run", default_run[1], "--max-depth", "3",
                 "--no-report-families", flag]) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("error: ")
    assert f"{key}=True" in out[0] and flag in out[0]
    assert _tree(tmp_path / "run") == before
    with pytest.raises(ResumeConflict, match=key):
        DiscoveryRun.resume("laplace", default_run[1],
                            config=SearchConfig(max_depth=3, **{key: False}),
                            db_path=db, device="cpu", verbose=False)
    assert _tree(tmp_path / "run") == before


def test_recorded_config_rules():
    """The rule on its own: no state keeps the config; a state from
    before ``prune`` was stored counts as pruned; a flag left on takes the
    stored setting, and one turned off against a stored on is refused."""
    from pde_engine_tpu_torch.runtime import recorded_config
    cfg = SearchConfig(prune=False)
    assert recorded_config(cfg, {}, "r") is cfg
    with pytest.raises(ResumeConflict, match="--no-prune"):
        recorded_config(cfg, {"include_special_ops": True}, "r")
    got = recorded_config(SearchConfig(), {"include_special_ops": False,
                                           "prune": False}, "r")
    assert (got.include_special_ops, got.prune) == (False, False)
    got = recorded_config(SearchConfig(include_special_ops=False),
                          {"include_special_ops": False}, "r")
    assert (got.include_special_ops, got.prune) == (False, True)


def _cli_rows(db, rid):
    con = sqlite3.connect(db)
    out = set(con.execute(
        "SELECT id, expression, signature, is_valid FROM expressions_"
        + rid.replace("-", "_")))
    con.close()
    return out


def _cli(d, *extra):
    """One CLI run of the port on laplace in ``d``; (db, report JSON)."""
    import json

    from pde_engine_tpu_torch.cli import main
    os.makedirs(d, exist_ok=True)
    db = os.path.join(d, "run.db")
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path", db,
                 "--no-report-families"] + list(extra)) == 0
    reps = sorted(f for f in os.listdir(d) if f.startswith("reproduction_"))
    with open(os.path.join(d, reps[-1])) as f:
        return db, json.load(f)


def test_mesh_resume_takes_the_recorded_flags(tmp_path, capsys):
    """A ``--devices 1`` mesh run under ``--no-special-ops --no-prune`` to
    depth 2, resumed to depth 3 on the mesh without either flag, equals
    the fresh mesh run to depth 3 row for row."""
    flags = ["--devices", "1", "--no-special-ops", "--no-prune"]
    fdb, frep = _cli(str(tmp_path / "fresh"), "--max-depth", "3", *flags)
    pdb, prep = _cli(str(tmp_path / "part"), "--max-depth", "2", *flags)
    _, rrep = _cli(str(tmp_path / "part"), "--devices", "1", "--resume-run",
                   prep["run_id"], "--max-depth", "3")
    assert rrep["by_depth"] == frep["by_depth"]
    assert rrep["dispatches"]["universal"] > 0
    assert _cli_rows(pdb, prep["run_id"]) == _cli_rows(fdb, frep["run_id"])


# ---------------------------------------------------------------------
# The configurations against the JAX package
# ---------------------------------------------------------------------

def _engines(name, seg=(True,), **flags):
    """The JAX engine's per-op path and the port's engine on each path of
    ``seg`` (True: segmented, False: per-op), to depth 3 under ``flags``."""
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    jax_eng = JaxEngine(jax_load_problem(name),
                        JaxSearchConfig(max_depth=3, use_segmented=False,
                                        **flags))
    jax_eng.run(3)
    ports = []
    for s in seg:
        eng = DiscoveryEngine(load_problem(name),
                              SearchConfig(max_depth=3, use_segmented=s,
                                           **flags), device="cpu")
        eng.run(3)
        ports.append(eng)
    return jax_eng, ports


def _knowns(eng):
    return {r.paper_solution_name for r in eng.valid_rows
            if r.paper_solution_name}


def _assert_matches(jax_eng, port):
    js = [(s.unique, s.valid) for s in jax_eng.stats]
    ps = [(s.unique, s.valid) for s in port.stats]
    assert ps[:2] == js[:2]
    for (pu, pv), (ju, jv) in zip(ps[2:], js[2:]):
        assert abs(pu - ju) <= D3_SPREAD * ju, (pu, ju)
        assert abs(pv - jv) <= D3_SPREAD * jv, (pv, jv)
    assert [s.candidates for s in port.stats] == \
        [s.candidates for s in jax_eng.stats]
    assert _knowns(port) == _knowns(jax_eng)


def _ops_used(eng):
    """The surface ops of the engine's composed uniques."""
    enum = eng.enumerator
    n = enum.count_uniques()
    return {enum._op_names[int(o)] for o in enum.u_op[:n] if o >= 0}


def test_no_special_ops_force_free_matches_jax():
    """force_free ``--no-special-ops`` to depth 3 on the port's segmented
    and per-op paths against the JAX package (4,676 candidates at depth
    3 on both sides); no unique is made by a special op."""
    jax_eng, ports = _engines("force_free", seg=(True, False),
                              include_special_ops=False)
    assert [s.candidates for s in jax_eng.stats][-1] == 4676
    for port in ports:
        _assert_matches(jax_eng, port)
        assert not _ops_used(port) & set(SPECIAL_OPS)
    seg, per_op = ports
    assert seg.dispatch_counts()["segmented"] > 0
    assert per_op.dispatch_counts()["universal"] > 0
    # the default op set spells special ops from depth 2 on
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    default = DiscoveryEngine(load_problem("force_free"),
                              SearchConfig(max_depth=2), device="cpu")
    default.run(2)
    assert _ops_used(default) & set(SPECIAL_OPS)


@pytest.mark.parametrize("name,key", [("laplace", "include_special_ops"),
                                      ("laplace", "prune"),
                                      ("force_free", "prune")])
def test_config_matches_jax(name, key):
    """laplace ``--no-special-ops``, laplace ``--no-prune`` and force_free
    ``--no-prune`` to depth 3 against the JAX package."""
    jax_eng, (port,) = _engines(name, **{key: False})
    _assert_matches(jax_eng, port)
    if name == "laplace":
        st = port.stats[-1]
        assert (st.candidates, st.unique, st.valid) == FLAGS[key][1]


def test_grad_shafranov_has_no_special_op():
    """grad_shafranov declares no special op, so ``--no-special-ops``
    leaves its run as it is: the port's rows equal its default run's,
    and its counts are the JAX package's under the flag."""
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine

    def rows(eng):
        return [(r.id, r.expression, r.signature, r.is_valid)
                for r in eng.rows]
    assert load_problem("grad_shafranov").special_ops == []
    engs = []
    for flag in (True, False):
        eng = DiscoveryEngine(load_problem("grad_shafranov"),
                              SearchConfig(max_depth=3,
                                           include_special_ops=flag),
                              device="cpu")
        eng.run(3)
        engs.append(eng)
    assert rows(engs[0]) == rows(engs[1])
    jax_eng = JaxEngine(jax_load_problem("grad_shafranov"),
                        JaxSearchConfig(max_depth=3, use_segmented=False,
                                        include_special_ops=False))
    jax_eng.run(3)
    _assert_matches(jax_eng, engs[1])


def _db_rows(db, cols):
    con = sqlite3.connect(db)
    table = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE name LIKE 'expressions_%'")]
    assert len(table) == 1
    out = con.execute(f"SELECT {cols} FROM {table[0]}").fetchall()
    con.close()
    return out


def _funnel(rows):
    """{signature: row} of the rows that reached the symbolic stage: the
    screen's and the float64 recheck's rejects are left out."""
    return {r[0]: r for r in rows if r[3] not in ("screen", "screen+f64")}


def test_sequential_heavy_checks_match_jax(tmp_path, capsys):
    """laplace ``--mode sequential --heavy-checks`` to depth 3 through both
    CLIs: the same counts; every row that reached the symbolic stage (the
    154 valid rows, each proved exact and passing the heavy checks) has
    the JAX run's signature, verdict, reason, method and heavy verdict;
    of the rows both hold, only screen-edge rejects differ."""
    from pde_engine_tpu.cli import main as jax_main
    from pde_engine_tpu_torch.cli import main
    argv = ["--problem", "laplace", "--max-depth", "3",
            "--no-report-families", "--mode", "sequential",
            "--heavy-checks"]
    jdb, pdb = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    assert jax_main(argv + ["--db-path", jdb]) == 0
    assert main(argv + ["--db-path", pdb, "--device", "cpu"]) == 0
    capsys.readouterr()
    jrows, prows = (_db_rows(db, FUNNEL_COLS) for db in (jdb, pdb))
    assert len(jrows) == len(prows) == 1878
    jf, pf = _funnel(jrows), _funnel(prows)
    assert jf == pf and len(jf) == 154
    assert {r[1:] for r in jf.values()} == {
        (1, "Valid (exact zero; heavy checks deferred)",
         "screen+f64+symbolic", 1, "ok")}
    j, p = {r[0]: r for r in jrows}, {r[0]: r for r in prows}
    differ = [s for s in set(j) & set(p) if j[s] != p[s]]
    assert len(differ) <= D3_SPREAD * len(j)
    for s in differ:
        assert j[s][1] == p[s][1] == 0
        assert {j[s][3], p[s][3]} <= {"screen", "screen+f64"}


def test_mode_sequential_is_confirm_symbolic(tmp_path, capsys):
    """``--mode sequential`` and ``--confirm-symbolic`` make the same run:
    laplace to depth 3, row for row in every stored verdict column; the
    default run keeps the same rows and verdicts but leaves the proof to
    ``--verify-pde`` (its valid rows' method ends in ``numeric``)."""
    cols = ("id, expression, signature, is_valid, validation_reason, "
            "validator_method, heavy_is_valid, heavy_reason")
    dbs = {}
    for tag, extra in (("seq", ["--mode", "sequential"]),
                       ("confirm", ["--confirm-symbolic"]),
                       ("default", [])):
        dbs[tag], _ = _cli(str(tmp_path / tag), "--max-depth", "3", *extra)
    capsys.readouterr()
    seq, conf, default = (_db_rows(dbs[t], cols)
                          for t in ("seq", "confirm", "default"))
    assert seq == conf
    assert [r[:4] for r in seq] == [r[:4] for r in default]
    assert {r[5] for r in default if r[3]} == {"screen+f64+numeric"}
    assert {r[5] for r in seq if r[3]} == {"screen+f64+symbolic"}
