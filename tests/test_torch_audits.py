"""The port's post-hoc audits against the JAX package's, on the CPU.

One run DB written by the JAX engine (laplace to depth 2, kerr to depth
2) is copied, and the JAX package's ``DiscoveryRun`` reads one copy while
the port's reads the other: the report from the DB (counts, knowns,
by-depth, novel classes), ``--verify-pde`` (the confirmed, refuted and
skipped sets), ``--heavy-validate`` (the ``heavy_*`` columns it writes),
``--certify`` (the certificates, equal apart from their timestamps and
paths, and accepted by ``tools/check_certificates.py``),
``--find-monopole`` and ``--audit-kerr``.  Every comparison is exact:
both sides run the same SymPy on the same rows.  Kerr's SymPy checks
are slow (its residual above all), so the kerr DB keeps its 9 depth-1
rows and every fourth of its 439 depth-2 rows, and its verify, heavy
and certify passes take the 8 shortest of those (it has no valid row
at depth 2).
"""

import json
import os
import shutil
import sqlite3
import subprocess
import sys

import pytest
import torch

from pde_engine_tpu.runtime import DiscoveryRun as JaxRun
from pde_engine_tpu.utils.config import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERR_LIMIT = 8
KERR_THIN = 4
# rows 1-9 are kerr's depth-1 rows, 10-448 its depth-2 rows
KERR_ROWS = 9 + sum(1 for i in range(10, 449) if i % KERR_THIN == 0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _two_readers(tmp, problem, depth, thin=1):
    """A JAX-engine run DB of ``problem`` to ``depth``, read by the JAX
    package (its copy ``jax.db``) and by the port (``port.db``); with
    ``thin`` only every ``thin``-th row deeper than depth 1 is kept."""
    os.makedirs(tmp / "jax")
    os.makedirs(tmp / "port")
    jdb, pdb = str(tmp / "jax" / "run.db"), str(tmp / "port" / "run.db")
    run = JaxRun(problem, config=JaxSearchConfig(max_depth=depth),
                 db_path=jdb, verbose=False)
    run.run(depth)
    rid = run.run_id
    table = run.db.table
    run.close()
    con = sqlite3.connect(jdb)
    con.execute(f"DELETE FROM {table} WHERE depth > 1 AND id % ? != 0",
                (thin,))
    con.commit()
    con.close()
    shutil.copy(jdb, pdb)
    jax = JaxRun(problem, config=JaxSearchConfig(max_depth=depth),
                 run_id=rid, db_path=jdb, verbose=False)
    port = DiscoveryRun(problem, config=SearchConfig(max_depth=depth),
                        run_id=rid, db_path=pdb, device="cpu",
                        verbose=False)
    return jax, port


@pytest.fixture(scope="module")
def laplace(tmp_path_factory):
    jax, port = _two_readers(tmp_path_factory.mktemp("laplace"), "laplace",
                             2)
    yield jax, port
    jax.close()
    port.close()


@pytest.fixture(scope="module")
def kerr(tmp_path_factory):
    jax, port = _two_readers(tmp_path_factory.mktemp("kerr"),
                             "kerr_magnetosphere", 2, thin=KERR_THIN)
    yield jax, port
    jax.close()
    port.close()


REPORT_KEYS = ("run_id", "problem", "max_depth", "total_generated",
               "total_valid", "by_depth", "paper_solutions_found",
               "paper_solutions_expected", "anchor_only_knowns",
               "novel_classes", "novel_classes_note", "family_breakdown")


@pytest.mark.parametrize("fixture", ["laplace", "kerr"])
def test_report_from_db_matches_jax(request, fixture):
    jax, port = request.getfixturevalue(fixture)
    want = jax.print_report_from_db()
    got = port.print_report_from_db()
    for k in REPORT_KEYS:
        assert got[k] == want[k], k
    if fixture == "laplace":
        assert got["by_depth"] == {"1": {"generated": 4, "valid": 2},
                                   "2": {"generated": 61, "valid": 17}}
        assert got["paper_solutions_found"]
    else:
        assert got["total_generated"] == KERR_ROWS
        assert got["total_valid"] == 0


def _audit_args(fixture):
    return (dict(scope="all") if fixture == "laplace"
            else dict(scope="all", limit=KERR_LIMIT))


@pytest.mark.parametrize("fixture", ["laplace", "kerr"])
def test_verify_pde_matches_jax(request, fixture):
    jax, port = request.getfixturevalue(fixture)
    want = jax.verify_pde_from_db(**_audit_args(fixture))
    got = port.verify_pde_from_db(**_audit_args(fixture))
    assert got == want
    if fixture == "laplace":
        assert len(got["confirmed"]) >= 19 and got["refuted"]


def _heavy_columns(run):
    con = sqlite3.connect(run.db_path)
    out = con.execute(f"SELECT id, heavy_is_valid, heavy_reason FROM "
                      f"{run.db.table} ORDER BY id").fetchall()
    con.close()
    return out


@pytest.mark.parametrize("fixture", ["laplace", "kerr"])
def test_heavy_validate_matches_jax(request, fixture):
    jax, port = request.getfixturevalue(fixture)
    assert jax.heavy_validate_from_db(**_audit_args(fixture)) == \
        port.heavy_validate_from_db(**_audit_args(fixture))
    got = _heavy_columns(port)
    assert got == _heavy_columns(jax)
    n = 65 if fixture == "laplace" else KERR_LIMIT
    assert sum(v is not None for _, v, _ in got) == n


def _certificates(out):
    with open(out["path"]) as f:
        doc = json.load(f)
    doc.pop("timestamp")
    return doc


@pytest.mark.parametrize("fixture", ["laplace", "kerr"])
def test_certify_matches_jax_and_checker(request, fixture):
    jax, port = request.getfixturevalue(fixture)
    want = jax.certify_from_db(**_audit_args(fixture))
    got = port.certify_from_db(**_audit_args(fixture))
    assert os.path.dirname(got["path"]) == port.out_dir
    assert got["counts"] == want["counts"] and got["n"] == want["n"]
    assert _certificates(got) == _certificates(want)
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "check_certificates.py"),
                        got["path"]], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    assert f"{got['n']} reproduced, 0 FAILED" in r.stdout


def test_find_monopole_matches_jax(kerr):
    jax, port = kerr
    want = jax.find_monopole_extensions(scope="all", target="either")
    assert port.find_monopole_extensions(scope="all", target="either") \
        == want
    assert want
    assert port.problem.monopole_target == jax.problem.monopole_target \
        == "1-x"


def test_audit_kerr_matches_jax(kerr):
    jax, port = kerr
    want = jax.audit_kerr_candidates(scope="all")
    got = port.audit_kerr_candidates(scope="all")
    assert got == want
    assert sum(len(v) for v in got.values()) == KERR_ROWS
    assert got["disguised_monopole"] and got["constant"]


def test_find_monopole_on_another_problem(laplace):
    assert laplace[1].find_monopole_extensions(scope="all") == []


def test_cli_audit_verbs(laplace, tmp_path, capsys):
    """``--print-run-id`` with every audit verb reads the port's copy of
    the laplace DB through the port's CLI."""
    from pde_engine_tpu_torch.cli import main
    port = laplace[1]
    db = str(tmp_path / "run.db")
    shutil.copy(port.db_path, db)
    capsys.readouterr()
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path", db,
                 "--print-run-id", port.run_id, "--verify-pde",
                 "--verify-scope", "valid", "--verify-limit", "5",
                 "--heavy-validate", "--heavy-limit", "5", "--certify",
                 "--certify-limit", "5", "--find-monopole", "--audit-kerr",
                 "--no-report-families"]) == 0
    out = capsys.readouterr().out
    assert "depth 2:       61 generated,     17 valid" in out
    assert "verify-pde [valid]: 5 confirmed, 0 refuted" in out
    assert "heavy-validate [valid]: 5 passed, 0 failed" in out
    assert "certify [valid]: 5 certificates" in out
    assert "find-monopole: not a Kerr problem" in out
    assert any(f.startswith("certificates_") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("verb", ["--print-run-id", "--watch-run"])
def test_cli_missing_db_creates_nothing(tmp_path, capsys, verb):
    from pde_engine_tpu_torch.cli import main
    db = tmp_path / "missing.db"
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path",
                 str(db), verb, "nope"]) == 1
    assert "Database not found" in capsys.readouterr().out
    assert os.listdir(tmp_path) == []


def test_watch_run_reads_a_finished_run(laplace, capsys):
    from pde_engine_tpu_torch.cli import main
    port = laplace[1]
    capsys.readouterr()
    assert main(["--problem", "laplace", "--device", "cpu", "--db-path",
                 port.db_path, "--watch-run", port.run_id]) == 0
    assert "[monitor] completed: generated=" in capsys.readouterr().out


def test_report_reads_str_depth_keys_as_one_int_key():
    """A saved generator state holds per-depth counts under str keys (it
    is JSON).  The port's report makes one int key of each, sorts depths
    as numbers and merges a partial depth of the valid rows with them;
    the JAX package's copy of the module mixes str and int keys and
    cannot sort them."""
    from pde_engine_tpu.utils.report import build_report as jax_build
    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.utils.report import build_report
    counts = {"1": {"generated": 4, "valid": 2},
              "10": {"generated": 9, "valid": 1},
              "2": {"generated": 61, "valid": 17}}
    valid = [{"depth": 3, "expression": "X", "paper_solution_name": None}]
    p = load_problem("laplace")
    rep = build_report(p, by_depth_counts=counts, valid_rows=valid,
                       classify_novel=False)
    assert list(rep["by_depth"]) == ["1", "2", "3", "10"]
    assert rep["by_depth"]["3"] == {"generated": 0, "valid": 1,
                                    "partial": True}
    assert rep["total_generated"] == 74
    with pytest.raises(TypeError):
        jax_build(p, by_depth_counts=counts, valid_rows=valid,
                  classify_novel=False)


def test_no_audit_report_reads_saved_counts(tmp_path):
    """A run without reject rows reports its totals from the saved
    generator state, as the JAX package's reader does on the same DB."""
    db = str(tmp_path / "run.db")
    run = DiscoveryRun("laplace", config=SearchConfig(max_depth=2,
                                                      audit_rejects=False),
                       db_path=db, device="cpu", verbose=False,
                       report_families=False)
    fresh = run.run(2)
    rid = run.run_id
    run.close()
    port = DiscoveryRun("laplace", run_id=rid, db_path=db, device="cpu",
                        verbose=False)
    got = port.print_report_from_db(families=False)
    port.close()
    jax = JaxRun("laplace", run_id=rid, db_path=db, verbose=False)
    want = jax.print_report_from_db(families=False)
    jax.close()
    assert got["by_depth"] == want["by_depth"]
    assert {d: (v["generated"], v["valid"])
            for d, v in got["by_depth"].items()} == \
        {d: (v["generated"], v["valid"]) for d, v in fresh["by_depth"].items()}
    assert got["total_generated"] == 65 and got["total_valid"] == 19
