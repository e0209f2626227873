"""The driver entry points of the port: counterparts of ``entry`` and
``dryrun_multichip`` in the JAX package's ``__graft_entry__.py``.

``entry(device="cuda")`` returns ``(kernel, example_args)``: force_free's
tape screen (``parallel.search.make_search_kernel_raw`` at 32 nodes) and
an 8-row batch of its known solutions and ``rho*z``, on the device.

    python -m pde_engine_tpu_torch.dryrun 8 --device cpu
    python -m pde_engine_tpu_torch.dryrun 2            # on the card(s)

Four checks over a mesh of ``n_devices`` shards, each printing one line
(any failure raises):

(a) the tape search kernel (``make_search_kernel``) shard by shard on a
    batch of known solutions and a non-solution, the survivors summed
    over the shards;
(b) a force_free depth-2 run of the incremental engine over the mesh
    (replicated cache): Vertical field among its valid rows;
(c) the uid-range call on a random cache split over the mesh: verdicts
    and jets identical to one ``universal`` launch over the whole cache;
(d) the shard-cache run of laplace to depth 3 with a per-device window
    of ``n_ref // K + 1`` rows (below the uniques, so one device would
    truncate): no truncation, the valid set of the one-device run.

On ``cuda`` the mesh takes the host's cards in turn, so that a host with
fewer cards than shards repeats them (two shards on one card, as the JAX
tests' virtual CPU devices share one CPU).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile

import numpy as np
import torch

from .models import load_problem
from .parallel import cuda_engine
from .parallel.incremental import JetCache, OP_INDEX, make_op_kernel_uidrange
from .parallel.mesh import CandidateMesh
from .parallel.search import (make_search_kernel, make_search_kernel_raw,
                              snap_fp_jets_np)
from .pipeline import DiscoveryEngine, cuda_emit_spec, resolve_device
from .runtime import DiscoveryRun
from .utils.config import SearchConfig

MAX_NODES = 32


def example_exprs(problem, n: int):
    """``n`` expressions: the problem's known solutions and ``rho*z``,
    cycled."""
    exprs = list(problem.known_solutions) + ["rho*z"]
    return (exprs * -(-n // len(exprs)))[:n]


def example_batch(problem, exprs):
    """The tapes of ``exprs`` padded to ``MAX_NODES`` and their lengths."""
    tapes = [problem.parse(s) for s in exprs]
    return (np.stack([t.padded(MAX_NODES) for t in tapes]),
            np.array([len(t) for t in tapes], np.int32))


def entry(device="cuda"):
    """``(kernel, example_args)``: force_free's tape screen at
    ``MAX_NODES`` nodes and an 8-row batch of its knowns and ``rho*z``,
    the arguments on ``device`` (``cuda`` without a card raises)."""
    dev = resolve_device(device)
    problem = load_problem("force_free")
    kernel = make_search_kernel_raw(
        problem.residual_order, MAX_NODES, problem.get_residual_key(),
        float(problem.screen_rtol), len(problem.screen_points),
        len(problem.fingerprint_points))
    tapes, lengths = example_batch(problem, example_exprs(problem, 8))
    example_args = tuple(torch.as_tensor(a).to(dev) for a in (
        tapes, lengths, problem.consts.as_array(np.float32),
        np.asarray(problem.screen_points, np.float32),
        np.asarray(problem.fingerprint_points, np.float32)))
    return kernel, example_args


def dryrun_mesh(n_devices: int, device="cuda") -> CandidateMesh:
    dev = resolve_device(device)
    if dev.type == "cpu":
        return CandidateMesh(["cpu"] * n_devices)
    count = torch.cuda.device_count()
    return CandidateMesh([torch.device("cuda", i % count)
                          for i in range(n_devices)])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """Run checks (a)-(d) over ``n_devices`` shards; returns what each
    found."""
    mesh = dryrun_mesh(n_devices, device)
    problem = load_problem("force_free")
    out = {}

    # (a) the tape search kernel, one call per shard
    kernel = make_search_kernel(
        problem.residual_order, MAX_NODES, problem.get_residual_key(),
        float(problem.screen_rtol), len(problem.screen_points),
        len(problem.fingerprint_points))
    exprs = example_exprs(problem, max(2 * n_devices,
                                       len(problem.known_solutions) + 1))
    host = example_batch(problem, exprs)
    n_pass = 0
    for dev, (lo, hi) in zip(mesh.devices, mesh.split(len(exprs))):
        if lo == hi:
            continue
        sr = kernel(*(torch.as_tensor(a).to(dev) for a in (
            host[0][lo:hi], host[1][lo:hi],
            problem.consts.as_array(np.float32),
            np.asarray(problem.screen_points, np.float32),
            np.asarray(problem.fingerprint_points, np.float32))))
        n_pass += int(sr.screen_ok.sum())
    want = sum(e != "rho*z" for e in exprs)
    if n_pass != want:
        raise AssertionError(f"(a) {n_pass} survivors, want {want}")
    out["tape_survivors"] = n_pass
    print(f"dryrun tape kernel: {n_pass} survivors of {len(exprs)} over "
          f"{mesh.size} shards", flush=True)

    # (b) the incremental engine over the mesh
    with tempfile.TemporaryDirectory() as tmp:
        run = DiscoveryRun("force_free", config=SearchConfig(
            max_depth=2, batch_size=1024), db_path=os.path.join(
                tmp, "run.db"), device=device, mesh=mesh, verbose=False,
            report_families=False)
        with contextlib.redirect_stdout(io.StringIO()):
            report = run.run(2)
        run.close()
    if not any("Vertical" in k for k in report["paper_solutions_found"]):
        raise AssertionError(f"(b) knowns {report['paper_solutions_found']}")
    out["engine"] = {"uniques": report["total_generated"],
                     "valid": report["total_valid"],
                     "survivors_last_batch": int(run.engine.mesh_survivors)}
    print(f"dryrun incremental engine over {mesh.size} shards: "
          f"{report['total_generated']} uniques, {report['total_valid']} "
          f"valid, survivors of the last batch "
          f"{out['engine']['survivors_last_batch']}", flush=True)

    # (c) uid-range verdicts against one launch over the whole cache
    spec = cuda_emit_spec(problem, problem.screen_rtol)
    rng = np.random.default_rng(3)
    rows, n = 8 * mesh.size, 2 * mesh.size + 1
    cs = rng.normal(size=(rows, spec.sdim)).astype(np.float32)
    cf = snap_fp_jets_np(rng.normal(size=(rows, spec.fdim)).astype(
        np.float32))
    ab = rng.integers(0, rows, size=(n, 2)).astype(np.int32)
    home = mesh.home
    sp = torch.as_tensor(np.asarray(problem.screen_points, np.float32),
                         device=home)
    fp = torch.as_tensor(np.asarray(problem.fingerprint_points, np.float32),
                         device=home)
    ref = cuda_engine.universal(spec, torch.as_tensor(cs, device=home),
                                torch.as_tensor(cf, device=home),
                                torch.as_tensor(ab, device=home),
                                OP_INDEX["mul"], sp, fp)
    cache = JetCache(spec.n_screen, spec.sdim // spec.n_screen, spec.n_fp,
                     home, initial_capacity=rows, mesh=mesh, sharded=True)
    cache.load_rows(cs, cf)
    got = make_op_kernel_uidrange(
        mesh, "mul", spec.order, spec.residual_key, spec.screen_rtol,
        spec.n_screen, spec.n_fp)(cache, torch.as_tensor(ab), sp, fp)
    for x, y in zip(ref, got[:3]):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError("(c) uid-range outputs differ from one "
                                 "launch over the whole cache")
    out["uidrange_survivors"] = int(got[3])
    print(f"dryrun uid-range-sharded cache ({rows} rows over {mesh.size} "
          f"shards): verdicts and jets identical, survivors "
          f"{int(got[3])}", flush=True)

    # (d) the production shard-cache run against one device
    ref_eng = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=3, use_segmented=False), device=home)
    ref_eng.run(3)
    n_ref = ref_eng.enumerator.count_uniques()
    mcr = n_ref // mesh.size + 1
    eng = DiscoveryEngine(load_problem("laplace"), SearchConfig(
        max_depth=3, max_cache_rows=mcr, shard_cache=True),
        device=home, mesh=mesh)
    eng.run(3)
    n_uniq = eng.enumerator.count_uniques()
    if not (n_uniq == n_ref and n_uniq > mcr and eng.cache.n == n_uniq):
        raise AssertionError(f"(d) {n_uniq} uniques (one device {n_ref}), "
                             f"cache {eng.cache.n}, window {mcr} a shard")
    if sorted(r.signature for r in eng.valid_rows) != \
            sorted(r.signature for r in ref_eng.valid_rows):
        raise AssertionError("(d) valid set differs from one device's")
    out["shard_cache"] = {"uniques": n_uniq, "window_per_shard": mcr,
                          "cache_rows": eng.cache.n,
                          "valid": len(eng.valid_rows)}
    print(f"dryrun shard-cache run: {n_uniq} uniques over a {mesh.size}-"
          f"shard window of {mcr} a shard, no truncation, valid set of the "
          "one-device run", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
