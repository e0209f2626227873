"""Command-line interface of the PyTorch/CUDA port.

    python -m pde_engine_tpu_torch --problem force_free --max-depth 4
    python -m pde_engine_tpu_torch --resume-run <run id> --max-depth 5
    python -m pde_engine_tpu_torch --print-run-id <run id> [--verify-pde]
        [--heavy-validate] [--certify] [--find-monopole] [--audit-kerr]
    python -m pde_engine_tpu_torch --watch-run <run id>
    python -m pde_engine_tpu_torch --devices 2 [--shard-cache]
    PDE_ENGINE_NUM_PROCESSES=2 PDE_ENGINE_PROCESS_ID=<rank> \
        PDE_ENGINE_COORDINATOR=127.0.0.1:<port> \
        python -m pde_engine_tpu_torch --multihost [--shard-registry]

Runs a fresh discovery, resumes a run and extends it to ``--max-depth``
(from its registry sidecar, or from the rows of its DB, with the op set
and pruning the run recorded: ``--no-special-ops`` or ``--no-prune`` on a
run recorded with the special ops or with pruning exits 2), reads a run
back from its DB with the post-hoc audits, or watches a live run, on an
explicit device type (``--device cuda`` by default; ``cpu`` runs the
plain torch kernels).  ``--devices K`` shards each batch over the first
K cards (K CPU shards with ``--device cpu``), with a replicated jet
cache or, with ``--shard-cache``, one split by uid range;
``--multihost`` runs one process per device on ``torch.distributed``
(``parallel/distributed.py`` says how a process finds the others), and
``--shard-registry`` splits the dedup map over the processes.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pde_engine_tpu_torch",
        description="Symbolic PDE-solution discovery on PyTorch + CUDA")
    p.add_argument("--mode", choices=["parallel", "sequential"],
                   default="parallel",
                   help="both modes run the device pipeline; sequential "
                        "also proves exact zeros inline with SymPy")
    p.add_argument("--problem", type=str, default="force_free",
                   help="force_free | kerr_magnetosphere | laplace | "
                        "grad_shafranov")
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=None,
                   help="candidates per kernel launch (default: auto — "
                        "262144 on CUDA, 16384 on CPU)")
    p.add_argument("--validators", type=int, default=0,
                   help="(compat) ignored: validation runs on the device")
    p.add_argument("--db-path", type=str,
                   help="run DB path (default: the problem's outputs dir)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="device of the run; cuda without a GPU is an error")
    p.add_argument("--devices", type=int, default=None,
                   help="shard each batch over the first K cards (K CPU "
                        "shards with --device cpu); more cards than the "
                        "host has are refused")
    p.add_argument("--multihost", action="store_true",
                   help="one process per device on torch.distributed: "
                        "PDE_ENGINE_NUM_PROCESSES, PDE_ENGINE_PROCESS_ID "
                        "and PDE_ENGINE_COORDINATOR (host:port), or "
                        "torchrun's WORLD_SIZE, RANK, MASTER_ADDR and "
                        "MASTER_PORT; rank 0 writes the run DB")
    p.add_argument("--shard-cache", action="store_true",
                   help="with --devices: split the device jet cache by uid "
                        "range over the mesh (device d holds rows "
                        "[d*C/K, (d+1)*C/K)), so the parent window is K x "
                        "--max-cache-rows")
    p.add_argument("--shard-registry", action="store_true",
                   help="with --multihost: each process keeps only its "
                        "slice of the dedup map (key mod processes), and "
                        "only the writer keeps display strings and "
                        "persists verdicts")
    p.add_argument("--no-special-ops", action="store_true",
                   help="Disable sqrt_shift/exp_mul/log_mul special ops")
    p.add_argument("--no-prune", action="store_true")
    p.add_argument("--no-audit-rejects", action="store_true",
                   help="screen/dedup/count rejects but store only valid "
                        "rows")
    p.add_argument("--max-cache-rows", type=int, default=None,
                   help="device jet-cache budget in rows (default: auto, "
                        "an ~11 GiB budget over the jet-row bytes)")
    p.add_argument("--spill-strings", nargs="?", const="auto",
                   default=None, metavar="DIR",
                   help="keep the display-string arena in an unlinked "
                        "temp file in DIR (default: the run DB's "
                        "directory), so that its pages can be evicted")
    p.add_argument("--omega", type=float, default=0.0,
                   help="Rigid field-line rotation rate (force_free only)")
    p.add_argument("--confirm-symbolic", action="store_true",
                   help="prove exact zeros inline with SymPy (slow; by "
                        "default left to --verify-pde)")
    p.add_argument("--heavy-checks", action="store_true",
                   help="run the regularity/finiteness/anchor checks "
                        "inline instead of leaving them to "
                        "--heavy-validate")
    p.add_argument("--no-report-families", action="store_true",
                   help="Skip the family-breakdown pass of the report")
    p.add_argument("--resume-run", type=str, metavar="RUN_ID",
                   help="resume a run and continue it to --max-depth")
    p.add_argument("--resume-validators", type=int, default=8,
                   help="(compat) ignored")
    p.add_argument("--print-run-id", type=str, metavar="RUN_ID",
                   help="print the report of an existing run from its DB")
    p.add_argument("--watch-run", type=str, metavar="RUN_ID",
                   help="print a live run's status every 5 s until it ends")
    p.add_argument("--verify-pde", action="store_true",
                   help="with --print-run-id: prove residual == 0 "
                        "symbolically for stored rows")
    p.add_argument("--verify-scope", choices=["novel", "valid", "all"],
                   default="novel")
    p.add_argument("--verify-limit", type=int, default=None,
                   help="verify at most N rows, the shortest first")
    p.add_argument("--heavy-validate", action="store_true",
                   help="with --print-run-id: run the heavy checks over "
                        "stored rows and store their verdicts")
    p.add_argument("--heavy-limit", type=int, default=None,
                   help="heavy-validate at most N rows, the shortest first")
    p.add_argument("--find-monopole", action="store_true",
                   help="with --print-run-id (kerr): rows whose a -> 0 "
                        "limit is the monopole")
    p.add_argument("--monopole-target", choices=["either", "1-x", "x"],
                   default="either")
    p.add_argument("--audit-kerr", action="store_true",
                   help="with --print-run-id (kerr): tag constant, "
                        "one-variable and disguised-monopole rows")
    p.add_argument("--certify", action="store_true",
                   help="with --print-run-id: write exactness "
                        "certificates for stored rows (check them with "
                        "tools/check_certificates.py)")
    p.add_argument("--certify-limit", type=int, default=None,
                   help="certify at most N rows, the shortest first")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR "
                        "(CPU activity, and CUDA activity on the GPU)")
    p.add_argument("--debug-nans", action="store_true",
                   help="after each screen launch, synchronise and raise "
                        "on a NaN in its outputs (kernel debugging only: "
                        "the screen makes NaNs on purpose wherever an op "
                        "leaves its domain)")
    return p


def _db_path_of(args, problem, run_id: str) -> str:
    from .utils.db import db_path_for
    return args.db_path or db_path_for(problem.get_output_dir(), run_id)


def _audit(args, problem, config) -> int:
    """``--print-run-id`` and its verbs.  The DB must exist first: RunDB
    creates the file it is given."""
    from .runtime import DiscoveryRun
    db_path = _db_path_of(args, problem, args.print_run_id)
    if not os.path.exists(db_path):
        print(f"Database not found: {db_path}")
        return 1
    run = DiscoveryRun(problem, config=config, run_id=args.print_run_id,
                       db_path=db_path, device=args.device)
    try:
        run.print_report_from_db(families=not args.no_report_families)
        if args.verify_pde:
            run.verify_pde_from_db(scope=args.verify_scope,
                                   limit=args.verify_limit)
        if args.find_monopole:
            run.find_monopole_extensions(scope=args.verify_scope,
                                         target=args.monopole_target)
        if args.audit_kerr:
            run.audit_kerr_candidates(scope=args.verify_scope)
        if args.heavy_validate:
            run.heavy_validate_from_db(scope=args.verify_scope,
                                       limit=args.heavy_limit)
        if args.certify:
            run.certify_from_db(scope=args.verify_scope,
                                limit=args.certify_limit)
    finally:
        run.close()
    return 0


def _profiled(args, fn):
    """``fn()``, under a torch.profiler trace written into
    ``args.profile`` when that is set."""
    if not args.profile:
        return fn()
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if args.device == "cuda" and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(args.profile, exist_ok=True)
    with profile(activities=acts) as prof:
        out = fn()
    path = os.path.join(args.profile, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    print(f"Profiler trace written to {path}")
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .models import load_problem
    from .parallel import cuda_engine
    from .runtime import DiscoveryRun, ResumeConflict
    from .utils.config import SearchConfig

    config = SearchConfig(
        max_depth=args.max_depth,
        batch_size=args.batch_size,
        include_special_ops=not args.no_special_ops,
        prune=not args.no_prune,
        confirm_symbolic=(args.confirm_symbolic
                          or args.mode == "sequential"),
        defer_heavy_checks=not args.heavy_checks,
        audit_rejects=not args.no_audit_rejects,
        max_cache_rows=args.max_cache_rows,
        spill_strings=args.spill_strings,
        shard_cache=args.shard_cache,
        shard_registry=args.shard_registry,
    )
    if args.shard_cache and not (args.devices or args.multihost):
        print("error: --shard-cache requires a mesh (--devices N)",
              flush=True)
        return 2
    if args.validators:
        print(f"note: --validators {args.validators} ignored: validation "
              "runs on the device")
    if args.omega:
        if not args.problem.startswith("force"):
            print("error: --omega applies to force_free only", flush=True)
            return 2
        from .models.force_free import ForceFreeProblem
        problem = ForceFreeProblem(omega=args.omega)
    else:
        problem = load_problem(args.problem)

    if args.watch_run:
        from .utils.monitor import watch
        db_path = _db_path_of(args, problem, args.watch_run)
        if not os.path.exists(db_path):
            print(f"Database not found: {db_path}")
            return 1
        watch(db_path, args.watch_run)
        return 0
    if args.print_run_id:
        return _audit(args, problem, config)

    from .parallel import distributed
    mesh = None
    if args.multihost:
        distributed.initialize(device=args.device)
        mesh = distributed.global_candidate_mesh(args.device)
    elif args.devices:
        from .parallel.mesh import candidate_mesh
        try:
            mesh = candidate_mesh(args.devices, args.device)
        except ValueError as e:
            print(f"error: {e}", flush=True)
            return 2
    kw = dict(config=config, db_path=args.db_path, device=args.device,
              report_families=not args.no_report_families, mesh=mesh)
    if args.resume_run:
        try:
            run = DiscoveryRun.resume(problem, args.resume_run, **kw)
        except ResumeConflict as e:
            # every rank reads the same stored state, so every rank is here
            print(f"error: {e}", flush=True)
            distributed.shutdown()
            return 2
        go = run.continue_run
    else:
        run = DiscoveryRun(problem, **kw)
        go = run.run
    nan_check = (cuda_engine.debug_nans() if args.debug_nans
                 else contextlib.nullcontext())
    try:
        with nan_check:
            _profiled(args, lambda: go(max_depth=args.max_depth))
    finally:
        run.close()
    # only after a run that ended well: a failed rank leaves, and the
    # others fail at their next collective instead of waiting here
    distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
