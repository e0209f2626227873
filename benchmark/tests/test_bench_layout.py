"""The benchmark's files, its contract and its result line (CPU).

    python -m pytest benchmark/tests -q

The driver's ``pytest tests/`` does not collect these.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import roofline, spec
from benchmark.run import FOREIGN, foreign_modules

ROOT = spec.ROOT
BENCH = spec.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_to_the_contract():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = BENCH["workloads"]
    assert [w["name"] for w in cells] == ["laplace.d5.heavy",
                                          "laplace.d5.heavy.no_families"]
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert list(e2e) == ["search_s", "host_peak_gib", "setup_s"]
    cell_names = {w["name"] for w in cells}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"]) and m["better"] == "lower"
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert set(m.get("workloads", [])) <= cell_names
    # every cell reports setup_s, another end-to-end metric and a
    # per-layer metric
    for w in cells:
        cell = spec.load_cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    layers = [m["name"] for m in BENCH["per_layer"]]
    assert layers == ["completion_s", "enum_s", "device_call_s",
                      "ingest_s", "ingest_rejects_s", "gray_s",
                      "untimed_s", "screen_roofline", "device_idle_pct",
                      "search_s.families", "completion_s.families"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", [])) <= cell_names
        # a cell that a metric lists reports what the metric moves
        for w in m.get("workloads", []):
            assert spec.applies(e2e[m["moves"]], w)
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    # the whole check fits its time: 2 + 14 x 24 runs of run_seconds + 60
    # and 2 x 90 s a cell, with 1200 s spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["max_depth"] == cell.depth
    assert cell.config["problem"] == "laplace"
    assert set(cell.config["limits"]) == {
        "count_gap", "count_d12_mismatch", "verdict_mismatch",
        "knowns_missing", "state_faults"}
    keys = cell.search_keys()
    from pde_engine_tpu_torch.utils.config import SearchConfig
    SearchConfig(**keys)         # every key is one of the program's
    reported = {m["name"] for m in cell.end_to_end}
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in BENCH["per_layer"]
        if spec.applies(m, name) and m["moves"] in reported]
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))


def test_an_extra_cell_is_only_new_files(tmp_path):
    """A later cell brings a configuration, a mix and a metric as new files
    and new entries; no file that is there changes."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: (bench_dir / p).read_bytes() for p in
              (str(q.relative_to(bench_dir))
               for q in bench_dir.rglob("*") if q.is_file())}
    cfg = json.loads((bench_dir / "configs" / "laplace_d5.json").read_text())
    cfg["max_depth"] = 4
    (bench_dir / "configs" / "laplace_d4.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "fresh_small_batch.json").write_text(
        json.dumps({"why": "x", "report_families": False,
                    "search_config": {"batch_size": 4096}}))
    (bench_dir / "metrics" / "depths_s.py").write_text(
        "def read(record):\n    return sum(s['seconds'] for r in "
        "record['runs'] for s in r['stats'])\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "laplace_d4", "source": "x",
                             "file": "benchmark/configs/laplace_d4.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "laplace.d4.small", "chips": 1,
                               "config": "laplace_d4",
                               "traffic": "fresh_small_batch", "why": "x"})
    # the new cell reports search_s: its name joins the metric's cells
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"] == "search_s":
            m["workloads"].append("laplace.d4.small")
    bench["per_layer"].append({"name": "depths_s", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "x", "moves": "search_s",
                               "workloads": ["laplace.d4.small"]})
    cell = spec.load_cell("laplace.d4.small", bench, str(bench_dir))
    assert cell.depth == 4 and cell.warmup_depth == 3
    assert cell.search_keys()["batch_size"] == 4096
    assert "depths_s" in [m["name"] for m in cell.per_layer]
    read = spec.metric_reader("depths_s", str(bench_dir))
    assert read({"runs": [{"stats": [{"seconds": 2.0}]}]}) == 2.0
    # the metric applies to its own cell alone
    other = spec.load_cell("laplace.d5.heavy", bench, str(bench_dir))
    assert "depths_s" not in [m["name"] for m in other.per_layer]
    for p, data in before.items():
        assert (bench_dir / p).read_bytes() == data, p


def _hand_bytes(cand, uniq, width):
    total, cached = 0, 0
    for c, u in zip(cand, uniq):
        total += cached * width + c * (4 + 4 + 12) + u * width
        cached += u
    return total


def test_roofline_bytes_match_a_hand_count():
    # force_free to depth 4: 552-byte rows (8 points x 15 + 6 x 3 floats)
    ff = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                     "force_free_d4.json"))
    assert roofline.run_bytes(ff) == \
        2_860 + 90_576 + 5_240_164 + 382_095_136
    # laplace to depth 5: 264-byte rows (8 points x 6 + 6 x 3 floats)
    lp = spec.load_cell("laplace.d5.heavy").config
    assert lp["row_bytes"] == (8 * 6 + 6 * 3) * 4
    assert roofline.run_bytes(lp) == _hand_bytes(
        [4, 69, 2193, 80036, 3300565], [4, 61, 1813, 67110, 2787664], 264)
    assert roofline.least_seconds(lp) == pytest.approx(
        840_540_308 / 3.35e12)


def test_foreign_modules_compare_top_level_names_whole(monkeypatch):
    assert FOREIGN == ("jax", "jaxlib", "flax", "pde_engine_tpu")
    for name in ("jax", "jax.numpy", "pde_engine_tpu.models", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    monkeypatch.setitem(sys.modules, "pde_engine_tpu_torch_x", object())
    assert foreign_modules() == ["flax", "jax", "pde_engine_tpu"]


def test_the_harness_and_the_port_load_no_jax():
    """What a run imports, in a process of its own: the harness, the port's
    run path and the reference load neither jax nor the JAX package."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import benchmark.run as r\n"
        "from benchmark.harness import check, trace, roofline\n"
        "from benchmark.reference import verdict\n"
        "import pde_engine_tpu_torch.runtime, pde_engine_tpu_torch.cli\n"
        "from pde_engine_tpu_torch.models import load_problem\n"
        "load_problem('force_free'); load_problem('laplace')\n"
        "print(r.foreign_modules())\n" % ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    ref_dir = os.path.join(spec.BENCH_DIR, "reference")
    for fn in os.listdir(ref_dir):
        if fn.endswith(".py"):
            with open(os.path.join(ref_dir, fn)) as f:
                src = f.read()
            assert not re.search(r"^\s*(from|import)\s+(pde_engine_tpu|jax)",
                                 src, re.M), fn


def test_without_a_card_it_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "laplace.d5.heavy", "--seed", str(2**31 + 3),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_alone_in_its_directory_it_fails_and_prints_no_result(tmp_path):
    """A directory with BENCHMARK.json and the files under ``paths`` only
    (no port) gives no result."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "laplace.d5.heavy", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
