"""The port's bench (``python -m pde_engine_tpu_torch.bench``) and ingest
sub-timers (``PDE_INGEST_TIMERS=1``) on the CPU.

The bench at ``--device cpu``, seed depth 2 and ``PDE_BENCH_BATCH=4096``
times the force_free depth-3 stream through the plain kernel twins: its
one JSON line must count the port engine's own depth-3 candidates and
launches at that batch.  laplace's depth-4 stream at batch 512 holds
the structured and tiled runs that stream lacks.  The timers must time
the sections of the JAX package's ``_ingest_vec`` by the same names,
only with the variable set, within ``t_ingest``, and the runtime must
print them after each depth.
"""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from pde_engine_tpu_torch import bench
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.pipeline import DiscoveryEngine
from pde_engine_tpu_torch.utils.config import SearchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "value", "unit", "vs_baseline")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench(capsys, monkeypatch, home, argv):
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("PDE_BENCH_BATCH", "4096")
    monkeypatch.delenv("PDE_BENCH_MAX_SUPERS", raising=False)
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_times_the_engines_depth3_stream(tmp_path, capsys,
                                               monkeypatch):
    """One JSON line with the JAX bench's four keys; its candidates,
    launches per kernel and launched rows are the port engine's own at
    depth 3 and the same batch; a second run loads the seed cache and
    times the same stream."""
    out = _bench(capsys, monkeypatch, tmp_path, ["2", "--device", "cpu"])
    assert all(k in out for k in KEYS)
    assert out["metric"] == "candidate_residual_validations_per_sec_per_chip"
    assert out["unit"] == "validations/s"
    assert out["vs_baseline"] == pytest.approx(out["value"] / 50.0)
    det = out["detail"]
    assert det["depth_timed"] == 3 and det["reps"] == 5
    assert not det["stream_truncated"] and not det["seed_cache_hit"]
    assert det["kernel_device_ms"] is None and det["card"] is None
    assert det["capacity_slack_rows"] >= bench.TILE - 1
    assert det["seconds"]["min"] <= det["seconds"]["median"] \
        <= det["seconds"]["max"]

    eng = DiscoveryEngine(load_problem("force_free"),
                          SearchConfig(max_depth=3, batch_size=4096),
                          device="cpu")
    eng.run(2)
    before = eng.dispatch_counts()
    rows_before = eng.launched_rows()
    eng.run(3, start_depth=3)
    after = eng.dispatch_counts()
    rows_after = eng.launched_rows()
    assert det["candidates_timed"] == eng.stats[2].candidates == 9965
    assert det["cache_uniques"] == 158
    assert det["launches"] == {k: after[k] - before[k]
                               for k in ("segmented", "structured",
                                         "tiled")}
    assert det["launches"]["segmented"] > 0
    assert det["launched_rows"] == {
        k: {f: rows_after[k][f] - rows_before[k][f] for f in v}
        for k, v in det["launched_rows"].items()}

    again = _bench(capsys, monkeypatch, tmp_path, ["2", "--device", "cpu"])
    assert again["detail"]["seed_cache_hit"]
    for k in ("candidates_timed", "launches", "launched_rows",
              "cache_uniques"):
        assert again["detail"][k] == det[k], k


def test_bench_routes_structured_and_tiled_runs_as_the_engine(
        tmp_path, monkeypatch):
    """laplace's depth-4 stream at batch 512 holds whole-superbatch and
    per-tile runs: the bench lays it out in the launches of each kind, of
    the rows, that the port engine's own depth 4 makes at that batch."""
    monkeypatch.setenv("HOME", str(tmp_path))
    eng, stream, _, hit, capacity = bench.seed(3, 512, torch.device("cpu"),
                                               problem="laplace")
    assert not hit and capacity - eng.cache.n >= bench.TILE - 1
    launches, truncated = bench.assemble(stream, 512,
                                         eng.config.tiled_min_rows, capacity)
    assert not truncated
    kinds = {k: sum(ln.kernel == k for ln in launches)
             for k in ("segmented", "structured", "tiled")}
    assert all(kinds.values()), kinds

    ref = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=4, batch_size=512, audit_rejects=False,
        snapshot_jets=False), device="cpu")
    ref.run(3)
    before, rows_before = ref.dispatch_counts(), ref.launched_rows()
    ref.run(4, start_depth=4)
    after, rows_after = ref.dispatch_counts(), ref.launched_rows()
    assert sum(ln.candidates for ln in launches) == ref.stats[3].candidates
    assert kinds == {k: after[k] - before[k] for k in kinds}
    assert bench.launched_rows(launches) == {
        k: {f: rows_after[k][f] - rows_before[k][f] for f in v}
        for k, v in bench.launched_rows(launches).items()}


def test_bench_seed_digest_ignores_where_the_sources_lie(tmp_path):
    """The seed cache is keyed by the sources' paths relative to the
    repository root: two copies at other absolute paths digest equal, and
    an edit to one changes its digest."""
    roots = []
    for name in ("a", "checkout_b"):
        root = tmp_path / name
        shutil.copytree(os.path.join(REPO, "pde_engine_tpu_torch"),
                        root / "pde_engine_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        roots.append(str(root))
    assert bench.source_digest(roots[0]) == bench.source_digest(roots[1]) \
        == bench.source_digest(REPO)
    with open(os.path.join(roots[1], "pde_engine_tpu_torch", "csrc",
                           "screen_kernel.cu"), "a") as fh:
        fh.write("\n")
    assert bench.source_digest(roots[0]) != bench.source_digest(roots[1])


def test_bench_sigterm_prints_at_most_one_line(capsys):
    """SIGTERM after the result line prints nothing more; before it, the
    partial measurement, flagged; with no measurement, nothing."""
    result = {"metric": "m", "value": 1.0, "unit": "u", "vs_baseline": 0.02,
              "detail": {"reps": 5}}
    out = bench.Output()
    out.partial = dict(result, detail={"reps": 4})
    out.emit(result)
    with pytest.raises(SystemExit) as e:
        out.on_sigterm()
    assert e.value.code == 143
    assert capsys.readouterr().out.splitlines() == [json.dumps(result)]

    out = bench.Output()
    out.partial = result
    with pytest.raises(SystemExit):
        out.on_sigterm()
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["detail"]["partial"] is True

    out = bench.Output()
    with pytest.raises(SystemExit):
        out.on_sigterm()
    assert capsys.readouterr().out == ""


def test_bench_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        bench.main(["2"])
    assert not os.path.exists(tmp_path / ".cache")


def _jax_section_names():
    """The names of the JAX package's ``_Section``s in ``_ingest_vec``."""
    with open(os.path.join(REPO, "pde_engine_tpu", "pipeline.py")) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "_ingest_vec")
    return {c.args[0].value for c in ast.walk(fn)
            if isinstance(c, ast.Call) and getattr(c.func, "id", "")
            == "_Section"}


_TIMED_RUN = r"""
import json, sys, tempfile
import torch
torch.set_num_threads(1)
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig
with tempfile.TemporaryDirectory() as d:
    run = DiscoveryRun("laplace", SearchConfig(max_depth=3), device="cpu",
                       db_path=d + "/run.db", report_families=False)
    rep = run.run(3)
    run.close()
print("STATS " + json.dumps(rep["stats"]))
"""


@pytest.mark.parametrize("timers", [True, False])
def test_ingest_sections_only_with_the_variable(timers):
    """With ``PDE_INGEST_TIMERS=1`` every depth >= 2 of a runtime run
    carries the JAX package's sections of ``_ingest_vec``, summing to no
    more than its ``t_ingest``, and the runtime prints them on an
    ``ingest breakdown:`` line after the depth line; without it there is
    neither."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("PDE_INGEST_TIMERS", None)
    if timers:
        env["PDE_INGEST_TIMERS"] = "1"
    r = subprocess.run([sys.executable, "-c", _TIMED_RUN], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    lines = r.stdout.splitlines()
    stats = json.loads(next(ln for ln in lines
                            if ln.startswith("STATS "))[6:])
    breakdowns = [i for i, ln in enumerate(lines)
                  if ln.startswith("    ingest breakdown: ")]
    if not timers:
        assert not breakdowns
        assert all(st["ingest_sections"] == {} for st in stats)
        return
    names = _jax_section_names()
    assert names == {"keys", "dedup", "register", "verdicts", "rejects",
                     "passers", "cache_append"}
    for st in stats[1:]:
        sec = st["ingest_sections"]
        assert set(sec) == names, sec
        assert 0 < sum(sec.values()) <= st["t_ingest"]
    assert stats[0]["ingest_sections"] == {}
    assert len(breakdowns) == 2
    for i, st in zip(breakdowns, stats[1:]):
        assert lines[i - 1].startswith(f"  depth {st['depth']}: ")
        got = dict(zip(lines[i].split()[2::2], lines[i].split()[3::2]))
        assert set(got) == names
