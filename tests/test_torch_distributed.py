"""The port's multi-process runs (``--multihost``) on ``torch.distributed``
with gloo, on the CPU: the counterparts of ``tests/test_distributed.py``
and ``tests/test_multiprocess.py``.

Two worker processes (a localhost coordinator, one CPU device each) run
the same laplace discovery through ``DiscoveryRun`` with the process
group's mesh and report a digest of their ingest:

- both ingest the same rows (uniques, rows, valid set, the display
  strings, the dedup keys), only rank 0 writes the run DB and the
  reports, and the all-gathered mesh call gives one ``universal_ref``'s
  rows over the whole batch, uneven shards included;
- with ``shard_registry``: depth 2, then resumed to depth 3 in the same
  two processes; the two dedup maps partition the keys, the key shard
  files exist, the non-writer keeps only the depth-1 strings, and the
  writer's valid set and uniques equal a one-process run's; a
  one-process resume of the two-process depth-2 run merges the two key
  shards and gives the same rows.
"""

import json
import os
import shutil
import socket
import sqlite3
import subprocess
import sys

import numpy as np
import pytest
import torch

from pde_engine_tpu_torch.parallel import distributed
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "paper_repro_20000101_000000_mptest"
SHARD_RUN = "paper_repro_20000101_000000_mpshard"

_PRELUDE = r"""
import json, os, shutil, sys
sys.modules["jax"] = None            # the port runs without jax
sys.modules["pde_engine_tpu"] = None
pid = int(sys.argv[1]); port = sys.argv[2]; shared = sys.argv[3]
import numpy as np
import torch
torch.set_num_threads(1)
from pde_engine_tpu_torch.parallel import distributed
assert distributed.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu")
mesh = distributed.global_candidate_mesh("cpu")
from pde_engine_tpu_torch.runtime import DiscoveryRun
from pde_engine_tpu_torch.utils.config import SearchConfig
"""

WORKER = _PRELUDE + r"""
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.parallel.distributed import make_op_kernel_multihost
from pde_engine_tpu_torch.parallel.incremental import (OP_INDEX, JetCache,
                                                      universal_ref)
from pde_engine_tpu_torch.pipeline import cuda_emit_spec

cfg = SearchConfig(max_depth=2, use_native=False)
run = DiscoveryRun("laplace", config=cfg, run_id=sys.argv[4],
                   db_path=os.path.join(shared, "mp.db"), device="cpu",
                   mesh=mesh, verbose=False, report_families=False)
rep = run.run(2)
enum = run.engine.enumerator
n = enum.count_uniques()
ks, vs = run.engine.fp_to_uid.items_arrays()
order = vs.argsort()

# the all-gathered call on odd batches against one universal_ref
p = load_problem("force_free")
spec = cuda_emit_spec(p, p.screen_rtol)
rng = np.random.default_rng(7)                     # the same on both ranks
cache = JetCache(spec.n_screen, spec.sdim // spec.n_screen, spec.n_fp,
                 "cpu", initial_capacity=64)
cache.append(torch.from_numpy(rng.normal(size=(64, spec.sdim)).astype(
    np.float32)), torch.from_numpy(rng.normal(size=(64, spec.fdim)).astype(
    np.float32)))
sp = torch.as_tensor(p.screen_points, dtype=torch.float32)
fp = torch.as_tensor(p.fingerprint_points, dtype=torch.float32)
same = []
for n_b, op in ((1, "mul"), (7, "exp"), (33, "add")):
    ab = torch.from_numpy(rng.integers(0, 64, size=(n_b, 2)).astype(np.int32))
    got = make_op_kernel_multihost(mesh, op, spec.order, spec.residual_key,
                                   spec.screen_rtol, spec.n_screen,
                                   spec.n_fp)(cache, ab, sp, fp)
    ref = universal_ref(spec.order, spec.residual_key, spec.screen_rtol,
                        spec.n_screen, spec.n_fp, cache.screen, cache.fp,
                        ab, torch.full((n_b,), OP_INDEX[op]), sp, fp)
    same.append(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(got[:3], ref))
                and int(got[3]) == int((ref[0][:, 2] & 1).sum()))
digest = {
    "pid": pid, "writer": bool(run.is_writer), "uniques": n,
    "n_rows": run.engine.n_rows,
    "valid": sorted(r.expression for r in run.engine.valid_rows),
    "exprs": [enum.expr_str_of(u) for u in range(n)],
    "keys": [int(k) for k in ks[order]],
    "by_depth": rep["by_depth"], "report_paths": rep["report_paths"],
    "kernel_same": same, "backend": rep["mesh"]["backend"],
}
run.close()
distributed.shutdown()
print("RESULT " + json.dumps(digest, sort_keys=True), flush=True)
"""

WORKER_SHARDED = _PRELUDE + r"""
cfg = SearchConfig(max_depth=3, use_native=False, shard_registry=True)
kw = dict(config=cfg, db_path=os.path.join(shared, "mpshard.db"),
          device="cpu", mesh=mesh, verbose=False, report_families=False)
run = DiscoveryRun("laplace", run_id=sys.argv[4], **kw)
run.run(2)
run.close()
distributed.barrier()
if pid == 0:                   # the depth-2 state, for a one-process resume
    shutil.copytree(shared, shared + "_d2")
distributed.barrier()
run2 = DiscoveryRun.resume("laplace", sys.argv[4], **kw)
run2.continue_run(3)
eng = run2.engine
enum = eng.enumerator
n = enum.count_uniques()
digest = {
    "pid": pid, "writer": bool(run2.is_writer), "uniques": n,
    "n_d1": int(enum.uid_array(1).size), "map_len": len(eng.fp_to_uid),
    "n_strings": sum(1 for i in range(n) if enum.expr_strs[i] is not None),
    "exprs": [enum.expr_str_of(u) for u in range(n)],
    "valid": sorted(r.expression for r in eng.valid_rows),
}
run2.close()
distributed.shutdown()
print("RESULT " + json.dumps(digest, sort_keys=True), flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_pair(tmp_path, src, shared, run_id):
    """Both workers' digests; one retry for the free port's race."""
    worker = tmp_path / "worker.py"
    worker.write_text(src)
    for pid in (0, 1):
        (tmp_path / f"host{pid}").mkdir(exist_ok=True)

    def attempt():
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        procs = [subprocess.Popen(
            [sys.executable, str(worker), str(pid), str(port), str(shared),
             run_id], cwd=tmp_path / f"host{pid}", env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for pid in (0, 1)]
        try:
            out = [p.communicate(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        return [p.returncode for p in procs], out

    codes, out = attempt()
    if any(codes):
        for d in (shared, shared.with_name(shared.name + "_d2")):
            shutil.rmtree(d, ignore_errors=True)
        shared.mkdir()
        codes, out = attempt()
    digests = []
    for code, (stdout, stderr) in zip(codes, out):
        assert code == 0, f"worker failed:\n{stdout}\n{stderr[-4000:]}"
        lines = [ln for ln in stdout.splitlines() if ln.startswith("RESULT ")]
        assert lines, stdout
        digests.append(json.loads(lines[0][len("RESULT "):]))
    return sorted(digests, key=lambda d: d["pid"])


def _stored_valid(db, run_id):
    conn = sqlite3.connect(db)
    rows = sorted(e for (e,) in conn.execute(
        f"SELECT expression FROM expressions_{run_id} WHERE is_valid=1"))
    conn.close()
    return rows


def _one_process(tmp_path, depth, name):
    ref = DiscoveryRun("laplace", config=SearchConfig(
        max_depth=depth, use_native=False, use_segmented=False),
        run_id=f"paper_repro_20000101_000000_{name}",
        db_path=str(tmp_path / f"{name}.db"), device="cpu", verbose=False,
        report_families=False)
    ref.run(depth)
    ref.close()
    return ref


def test_two_process_run(tmp_path):
    shared = tmp_path / "shared"
    shared.mkdir()
    d0, d1 = _run_pair(tmp_path, WORKER, shared, RUN)
    assert d0["writer"] is True and d1["writer"] is False
    assert d0["backend"] == d1["backend"] == "gloo"
    for key in ("uniques", "n_rows", "valid", "exprs", "keys", "by_depth"):
        assert d0[key] == d1[key], key
    assert d0["uniques"] > 10 and d0["valid"]
    assert d0["kernel_same"] == d1["kernel_same"] == [True] * 3
    # one writer: one report set beside the shared DB, nothing elsewhere
    assert d1["report_paths"] is None
    assert len(list(shared.rglob("reproduction_*.json"))) == 1
    for pid in (0, 1):
        assert not list((tmp_path / f"host{pid}").rglob("*"))
    assert _stored_valid(shared / "mp.db", RUN) == d0["valid"]
    ref = _one_process(tmp_path, 2, "mpref")
    assert sorted(r.expression for r in ref.engine.valid_rows) == d0["valid"]


def test_two_process_sharded_registry(tmp_path):
    shared = tmp_path / "shared"
    shared.mkdir()
    d0, d1 = _run_pair(tmp_path, WORKER_SHARDED, shared, SHARD_RUN)
    assert d0["writer"] is True and d1["writer"] is False
    assert d0["uniques"] == d1["uniques"] > 100
    assert d0["exprs"] == d1["exprs"]
    n = d0["uniques"]
    assert d0["map_len"] < n and d1["map_len"] < n
    assert d0["map_len"] + d1["map_len"] == n
    assert d1["n_strings"] == d1["n_d1"] < d0["n_strings"]
    ref = _one_process(tmp_path, 3, "mpshardref")
    ref_valid = sorted(r.expression for r in ref.engine.valid_rows)
    assert d0["valid"] == ref_valid
    assert d0["uniques"] == ref.engine.enumerator.count_uniques()
    assert _stored_valid(shared / "mpshard.db", SHARD_RUN) == d0["valid"]
    for rank in (0, 1):
        assert (shared / f"mpshard.db.registry.keys.{rank}.npz").exists()
    # one process resumes the two-process depth-2 run: it merges the two
    # key shards and gives the one-process run's rows
    d2 = tmp_path / "shared_d2"
    with np.load(d2 / "mpshard.db.registry.npz") as z:
        assert int(z["keys_sharded"]) == 2
    run = DiscoveryRun.resume(
        "laplace", SHARD_RUN, config=SearchConfig(
            max_depth=3, use_native=False, use_segmented=False),
        db_path=str(d2 / "mpshard.db"), device="cpu", verbose=False,
        report_families=False)
    assert len(run.engine.fp_to_uid) == 65
    run.continue_run(3)
    run.close()
    assert _stored_valid(d2 / "mpshard.db", SHARD_RUN) == ref_valid
    assert run.engine.enumerator.count_uniques() == n


def test_resume_refuses_stale_key_shards(tmp_path):
    """A key shard of another run (its run_id) is never merged."""
    run = DiscoveryRun("laplace", config=SearchConfig(max_depth=1),
                       run_id="paper_repro_20000101_000000_stale",
                       db_path=str(tmp_path / "s.db"), device="cpu",
                       verbose=False, report_families=False)
    np.savez(run._keys_shard_path(0), keys=np.zeros(1, np.uint64),
             uids=np.zeros(1, np.int64), world=np.int64(2),
             run_id=np.str_("another"))
    with pytest.raises(RuntimeError, match="another run"):
        run._load_sharded_keys(1, 2)
    run.close()


def test_initialize_single_process_is_noop(monkeypatch):
    for k in ("PDE_ENGINE_NUM_PROCESSES", "PDE_ENGINE_COORDINATOR",
              "PDE_ENGINE_PROCESS_ID", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize(device="cpu") is False
    monkeypatch.setenv("PDE_ENGINE_NUM_PROCESSES", "1")
    assert distributed.initialize(device="cpu") is False
    assert distributed.is_writer() is True
    assert distributed.registry_shard() == (0, 1)
    mask = np.array([True, False, True])
    assert distributed.or_reduce_mask(mask) is mask
    assert distributed.global_candidate_mesh("cpu").devices == (
        torch.device("cpu"),)
    assert distributed.agree("x") == "x"


def test_resolution_order(monkeypatch):
    """Explicit arguments, then PDE_ENGINE_*, then torchrun's variables."""
    for k in ("PDE_ENGINE_NUM_PROCESSES", "PDE_ENGINE_COORDINATOR",
              "PDE_ENGINE_PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1234")
    assert distributed._resolve(None, None, None) == ("10.0.0.1:1234", 4, 3)
    monkeypatch.setenv("PDE_ENGINE_NUM_PROCESSES", "2")
    monkeypatch.setenv("PDE_ENGINE_PROCESS_ID", "1")
    monkeypatch.setenv("PDE_ENGINE_COORDINATOR", "h:9")
    assert distributed._resolve(None, None, None) == ("h:9", 2, 1)
    assert distributed._resolve("a:1", 3, 0) == ("a:1", 3, 0)


def test_backend_follows_the_cards():
    """NCCL only when every local process has a card of its own; gloo on
    the CPU and when processes share a card."""
    cpu = distributed.choose_backend("cpu", 2, 1, 0)
    assert cpu[:2] == ("gloo", torch.device("cpu"))
    shared = distributed.choose_backend("cuda", 2, 1, 1)
    assert shared[:2] == ("gloo", torch.device("cuda", 0))
    own = distributed.choose_backend("cuda", 4, 3, 4)
    assert own[:2] == ("nccl", torch.device("cuda", 3))
    with pytest.raises(RuntimeError, match="no usable card"):
        distributed.choose_backend("cuda", 2, 0, 0)
