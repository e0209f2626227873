#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pde_engine_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py                  # phases 1-13 and 18-22
    python3 chip_smoke.py --phases 3,9     # a subset (no result line)
    python3 chip_smoke.py --phases 14      # force_free depth 5, alone
    python3 chip_smoke.py --phases 21      # phase 21, --no-prune to depth 4

The whole script runs with ``PDE_INGEST_TIMERS=1``: every depth of every
run prints its ingest sections below its stage line, and a depth whose
sections are missing or sum above its ``t_ingest`` fails.

Phases, one line each (any failure exits non-zero):

1. device   — the card's name and power limit (nvidia-smi), torch/CUDA;
2. build    — nvcc-builds the screen kernels of force_free, laplace,
              kerr_magnetosphere, grad_shafranov and force_free's Ω
              variant (``--omega 1.0``: residual key
              ``force_free@omega=1.0``, a fifth build) from the
              checkout's sources into build/torch_ext/ (one nvcc per
              build, all started together); prints each entry point's
              registers,
              shared memory and spills (-Xptxas -v; a spill fails), its
              dynamic shared memory and resident blocks per SM, and the
              candidates per block that structured and universal take
              at their paths' launch shapes;
3. kernels  — each of the four kernels (segmented, structured, tiled,
              universal) against its plain torch twin on the card, on
              262,144-candidate launches over a seeded random cache of
              4 x 262,144 rows, covering all 18 surface ops (universal:
              one launch per op); time per launch, plain time, and the
              roofline bound of the same work; segmented and tiled also
              on a partial launch (segmented: 19,021 rows in op runs of
              1-199 rows, so runs end inside warps; tiled: 37 tiles of
              512); structured also at its path's launch shape (4,096
              rows), runs ending at the cache's last row included;
              universal also at the per-op path's launch shape (502
              rows, the mean of a depth-4 per-op launch), with the host
              round trip of one such launch, and at 1 and 37 rows; at
              the two path shapes each is timed three ways: the entry
              point called back to back (host work included), the
              kernel alone (50 launches replayed from a CUDA graph), and
              an isolated launch after the card idled 5 ms, as the paths
              launch; all four again on the laplace, kerr and
              grad_shafranov builds (order 2), full and small launches,
              with the same rules; all four on the Ω build, with the
              order-2 builds' checks; then each kernel's ms per
              262,144-row launch on the force_free and Ω builds, timed in
              turns on the same inputs, beside its bound, and on each
              order-2 build at its own widths and points (T = 6);
4. main     — ``python -m pde_engine_tpu_torch --problem force_free
              --max-depth 4 --device cuda`` through ``cli.main``: 7/7
              known solutions, exact depth-1/2 counts, depth-3/4 counts
              within 1% of the TPU run; every segmented and tiled launch
              timed with CUDA events (summed kernel ms and launched
              rows; segmented must launch exactly its candidates, tiled
              exactly the 512-row tiles that hold one);
5. structured coverage — depth 4 again with ``--batch-size 4096``, which
              takes the structured kernel (every launch timed with CUDA
              events, as in phase 4); every valid key of either run
              must be a key of the other, and a key's verdict may differ
              only where the two runs kept another expression for it
              (each such key is printed with both expressions and their
              float64 relative residuals); valid counts agree within
              0.1%;
6. per-op   — ``DiscoveryRun("force_free", SearchConfig(max_depth=4,
              use_segmented=False), device="cuda")``, the path of the
              universal kernel: 7/7 knowns, depths 1-2 with phase 4's
              keys and counts, depths 3-4 uniques and valid within 0.1%
              of phase 4 (the per-op path screens candidates in another
              order, so a key can keep another expression); the keys
              found by only one of the two runs are counted per depth,
              and each key whose verdict differs is printed; every
              universal launch timed with CUDA events, and the launched
              rows must equal the candidates;
7. resume   — a CLI depth-3 run, then ``--resume-run <id> --max-depth
              4``: its depth-4 rows equal phase 4's row for row (id,
              expression, signature, is_valid); its depth-4 stage and
              ingest sections beside phase 4's;
8. per-op resume without a jet snapshot — depth 3 with
              ``use_segmented=False, snapshot_jets=False``, resumed to
              depth 4: the cache is rebuilt by replaying composed rows
              through ``universal``, and the rows equal phase 6's row
              for row (its universal launches timed as in phase 6);
9. families — ``--problem kerr_magnetosphere``, ``laplace`` and
              ``grad_shafranov``, each ``--max-depth 4`` (phase 16 takes
              laplace to depth 5) through ``cli.main``: depths 1-2
              exact, depths 3 and up
              within 1% of the TPU artifacts, the knowns the JAX package
              finds on the CPU at depth 3, kerr's monopole valid at its
              anchor a -> 0; each stage's split and the kernels' device
              time from the CUDA activity trace;
10. post-hoc — ``--print-run-id <phase 4's run> --verify-pde
              --heavy-validate --certify`` (each on the 200 shortest
              valid rows) through ``cli.main``: the report's per-depth
              counts and knowns equal phase 4's, no row refuted, and
              ``tools/check_certificates.py`` reproduces every
              certificate; then ``--find-monopole --audit-kerr
              --verify-scope all`` on a kerr depth-2 run, with the JAX
              package's results on the same rows;
11. DB-rebuild resume — phase 7's and phase 8's depth-3 runs, copied
              before their resumes and their registry sidecars removed,
              resumed to depth 4 from their DB rows (the structural fast
              path): (a) the CLI resume with the jet snapshot gives phase
              4's depth-4 rows, (b) the per-op resume without one phase
              6's rows, row for row; (c) phase 7's run as old as the
              struct columns (every triple NULL, no sidecar, no jet
              snapshot), resumed through ``cli.main``: the log's ``parse
              path`` line with 0 leaves, the cache replay's launches by
              kind (at least one), phase 4's depth-4 rows row for row;
              each resumed depth-4 stage and its ingest sections beside
              the fresh run's;
12. bench    — ``python -m pde_engine_tpu_torch.bench 3`` (the depth-4
              stream at the default batch) in a process of its own: one
              JSON line with the JAX bench's keys, phase 4's depth-4
              candidates in phase 4's depth-4 launches of each kind, the
              first launch of each kind bit-equal to its plain twin, its
              own launch counts those of its warm-up and repetitions,
              and the kernels' and verdict copies' device ms measured;
13. canaries — a no-audit force_free depth-4 run through
              ``DiscoveryEngine``: 7/7 knowns, phase 4's counts, and the
              three recall canaries of ``pde_engine_tpu_torch/canary.py``
              recovered as valid rows; its launches' rows counted.

18. Ω        — ``--problem force_free --omega 1.0 --max-depth 4
              --no-audit-rejects`` through ``cli.main``: depths 1-2 equal
              to the JAX package's CPU counts, depths 3-4 within 1% of
              them, its knowns (5 of 7 hold under rotation); the per-op
              path to depth 3 and ``--batch-size 4096`` to depth 4, so
              that each of the Ω build's four kernels is launched (each
              pass's launch counts printed); then ``--print-run-id <id>
              --omega 1.0 --verify-pde`` on the 200 shortest valid rows:
              none refuted;
19. tape     — ``DiscoveryEngine(force_free, SearchConfig(engine=
              "tape"), device="cuda")`` to depth 3: the JAX tape engine's
              CPU counts and key digests, the cache rows on the card, no
              screen-kernel launch; then ``make_search_kernel`` on the
              card for force_free's seven knowns and ``rho*z`` (the
              library smoke): knowns under 1e-6, ``rho*z`` about 0.78,
              verdicts equal to the CPU twin's, jets within 3e-5 of them
              (scaled);
20. mesh     — the multi-device paths on the one card, force_free depth
              4 at the default batch: (a) ``--devices 1`` through
              ``cli.main``, whose rows must equal the per-op path's row
              for row (phase 6's run, else one of its own) with 7/7;
              (b) through the library on a mesh ``[cuda:0, cuda:0]``
              with a replicated cache and (c) with ``shard_cache=True``,
              each to depth 3 with (a)'s rows of depths 1-3, then (c) to
              depth 4 with a window of ``9,134 // 2 + 1`` rows a shard:
              no truncation, (a)'s rows row for row, 7/7; each run's
              ``universal`` launches must be the engine's count of
              non-empty shards, and no other kernel launches; (d) two ``--multihost --shard-registry`` CLI
              processes sharing the card over gloo
              (``PDE_ENGINE_NUM_PROCESSES=2``, ``PDE_ENGINE_PROCESS_ID``,
              ``PDE_ENGINE_COORDINATOR`` on a free local port), to depth
              2 and resumed to depth 3 (``MULTIHOST_DEPTH``): each names
              gloo on its first line, both ranks print the same
              per-depth counts, their dedup maps sum to the uniques,
              both key shard files exist, rank 1 writes nothing, the
              writer's rows equal (a)'s rows of those depths, and
              both ranks launch ``universal``; a failed rank kills the
              pair and fails the phase; (e) ``dryrun_multichip(2,
              "cuda")`` and ``python -m pde_engine_tpu_torch.bench
              --devices 1`` in a process of its own: (a)'s depth-4
              candidates, and (a)'s depth-4 launches in each repetition;
21. configurations — the JAX CLI's other run configurations through
              ``cli.main``, each held to the JAX package's CPU run
              (``NSO_JAX``, ``NP_JAX``, ``SEQ_JAX``: depths 1-2 exact,
              deeper within 1%, its knowns): force_free
              ``--no-special-ops --max-depth 4`` (no row may spell a
              special op), its per-op path to depth 3 (universal only,
              within 0.1% of the default path) and ``--batch-size 4096``
              to depth 4 (structured), laplace ``--mode sequential
              --heavy-checks --max-depth 3`` (the rows that reached the
              symbolic stage: their count and digest of (signature,
              verdict, reason, method, heavy verdict) equal the JAX
              run's, no symbolic error), and force_free ``--no-prune``
              to depth 3, or to depth 4 when ``--phases`` names the
              phase; each force_free configuration run to one depth less
              and resumed without its flag from its sidecar and, in a
              copy without it, from its DB rows, each equal to the fresh
              run row for row, after a resume asking for a flag the run
              recorded on (``--no-prune`` on the ``--no-special-ops``
              run, and the other way round) has exited 2 with one line
              and changed no file of the run; each of the four kernels
              must launch in the phase;
22. surface  — the library calls with jax blocked: (a)
              ``pde_engine_tpu_torch.load_problem("force_free")``,
              ``utils.SearchConfig`` and ``ops.{jets, optable, tape}``
              resolve, and ``dryrun.entry()`` runs on the card: its
              screen_ok is the JAX package's (the seven knowns pass,
              ``rho*z`` does not) and its verdict flags and fingerprints
              the CPU's; (b) ``summary()`` of phase 13's engine, printed
              on one line: its totals those of the engine's stats, 7
              knowns, ``candidates_screened`` the oracle's rows and the
              launched candidates, the rows phase 13's launches counted
              the engine's; (c) a copy of ``pde_engine_tpu_torch/``
              alone in a temporary directory (an installed package's
              layout), run in a process of its own with ``HOME`` and
              ``XDG_CACHE_HOME`` in another: it builds the native core
              and force_free's kernels under
              ``$XDG_CACHE_HOME/pde_engine_tpu_torch``, launches
              ``universal`` once bit-equal to its plain twin, and writes
              nothing inside the copy.

Phases 14-17 run only when ``--phases`` names them (each alone fills
much of a call):

14. depth 5 — ``--problem force_free --max-depth 5 --no-audit-rejects``
              through ``cli.main``, a progress line on stderr every
              minute (the ``--watch-run`` status, the ingest sections so
              far, peak RSS, device memory): depths 1-2 exact, 3-5 within
              1% of the TPU run (report_20260820_090829.txt), 7/7 knowns;
              then the whole bench (seed depth 4) with phase 12's checks
              against this run's depth 5: its candidates, and its
              launches of each kind;
15. depth 5 audited — the same run with its reject rows written;
16. laplace  — ``--max-depth 5`` at the default batch, at
              ``--batch-size 4096`` and on the per-op path; each key whose
              verdict differs from the default run's is classed by
              whether the kept expression differs;
17. host     — two more fresh force_free depth-4 runs (the spread of
              the stage), the second with its main thread's stack
              sampled through its depth stages, and a depth-3 run
              resumed to depth 4 in turns with its DB's secondary
              indices kept and dropped.

The launch counts are reset just before each run of phases 4-9, 11,
13-15 and 18-21 and read just after it (phases 4, 14 and 15 also by
depth);
the bench process of phases 12 and 14 sets its own to 0 after its seed,
just before its warm-up, and reports them in its line.  In the kernels
line, ``launches`` is each kernel's count on its own path: phase 4 (the segmented main path, default batch) for
segmented and tiled, phase 5 (``--batch-size 4096``) for structured,
phase 6 (the per-op path) for universal; ``launches_by_phase`` has
every phase's counts; ``path_ms`` and ``live_rows`` are the summed
CUDA-event windows around the launches and the launched rows on that
path, ``path_device_ms`` the kernels' summed device time read from the
CUDA activity trace (null where none was taken): the card idles between
a path's launches, and an event window then holds its wake-up as well;
``path`` the launches' rows and event-window ms (each launch for
segmented, tiled and structured; a summary by launch size for
universal, whose every launch of phases 6 and 8 goes to
``build/chip_smoke_launches.json``).  Phase 4
takes no structured launch at depth 4 (every contiguous run is shorter
than a 262,144 superbatch); phase 5 does.  ``bound_ms`` is the larger
of the bytes the launch must move (each distinct operand row read once,
its index arrays, its outputs written: 564 B a force_free candidate)
over 3.35 TB/s and its float operations (the emitted jet algebra and
residual, counted per op
by ``ops/cuda_emit.op_counts``) over 67 TFLOP/s: the H100 SXM data
sheet; a cache row and a candidate's outputs count the family's own
jet widths (``row_bytes``, ``out_bytes``).  ``family_builds`` holds
each order-2 build's registers, spills, blocks per SM, mismatching
rows, and its ms per 262,144-row launch with its bound;
``family_launches`` each kernel's launches in phase 9;
``omega_build`` the Ω build's registers, spills, its ms per 262,144 rows
beside force_free's from the same turns, its bound, its error against
its twin and its launches in each pass of phase 18; the lines
before the kernels line hold phase 9's runs (``families``), phase 12's
bench line (``bench``), phases 14-15's runs (``depth5``), phase 18's
(``omega``), phase 19's (``tape``), phase 20's (``mesh``), phase
21's (``configs``) and phase 22's (``surface``), each where its phase
ran; ``launches_by_phase`` holds phase 20's runs under
``mesh_*``, ``multihost_rank*`` (each rank's own count, both of its
runs), ``dryrun`` and ``mesh_bench``, and phase 21's under
``configs_*`` (each kernel's also in ``config_launches``).
``path_shape`` holds structured's and universal's numbers at
their paths' launch shapes.  The last lines are one JSON object
describing the kernels, the card line and the result object.  Imports
no jax and nothing of the JAX package.
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

# the port must not need jax or the JAX package: make any import of
# either fail loudly
sys.modules["jax"] = None
sys.modules["pde_engine_tpu"] = None
# the port reads its ingest sub-timers' switch when it is imported
os.environ["PDE_INGEST_TIMERS"] = "1"

TPU_REF = {3: (8974, 2155), 4: (656856, 59865)}   # uniques, valid (TPU run)
EXACT = {1: (5, 4), 2: (153, 93)}
SUPER = 262144
PER_OP_ROWS = 502    # the per-op path's mean launch at depth 4 (723,618
                     # candidates / 1,440 launches of pipeline._eval_op_idx)
STRUCT_ROWS = 4096   # a structured launch at --batch-size 4096
RAGGED_ROWS = (1, 37)  # universal launches whose last block ends in a warp
DEPTH3_ROWS = 9134   # cache rows of the depth <= 3 uniques (5 + 153 + 8,976)
MESH_LIB_DEPTH = 3   # phase 20's (b) and (c) with the default window
# phase 20's (d): the pair runs to one depth less and is resumed to this
# one (depth 3 keeps the default run well inside its time limit)
MULTIHOST_DEPTH = 3
EXP_LOG_OPS = ("exp", "exp_neg", "log", "exp_mul", "log_mul")
ULP_BOUND = 4
VALID_SPREAD = 0.001  # phases 5 and 6 vs phase 4 valid counts per depth
REPLACES = {
    "segmented": "pde_engine_tpu/parallel/pallas_engine.py:394",
    "structured": "pde_engine_tpu/parallel/pallas_engine.py:546",
    "tiled": "pde_engine_tpu/parallel/pallas_engine.py:695",
    "universal": "pde_engine_tpu/parallel/pallas_engine.py:226",
}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
PARTIAL_TILES = 37  # tiles of the partial tiled launch
PARTIAL_ROWS = PARTIAL_TILES * 512 + 77  # rows of the partial segmented one
GROUP_KERNELS = ("segmented", "tiled")
OWN_PATH = {"segmented": "main", "structured": "batch_4096",
            "tiled": "main", "universal": "per_op"}
N_PHASES = 22
# 14-17 run only when asked for; 18-22 came later, in the default set
DEFAULT_PHASES = set(range(1, 14)) | {18, 19, 20, 21, 22}
# phases 14-15: the TPU run of force_free to depth 5,
# problems/force_free/outputs/report_20260820_090829.txt (59,171,371
# depth-5 candidates in its reproduction JSON)
TPU_D5 = {3: (8974, 2155), 4: (656856, 59865), 5: (53940644, 1858749)}
WATCH_S = 60   # seconds between the progress lines of phases 14-15
# phase 9: family -> (depth, {depth: the TPU artifact's (uniques, valid)},
# exact counts at depths 1-2, the knowns the JAX package finds on the CPU
# at depth 3); the run holds the counts of its depths.  Laplace and
# grad_shafranov ran to depth 5 here before phases 18-19 joined the
# default set; at depth 4 the default run keeps within its time.
# Artifacts: problems/kerr_magnetosphere/outputs/
# report_20260820_181935.txt, problems/laplace/outputs/
# report_20260820_184232.txt, problems/grad_shafranov/outputs/
# report_20260820_151035.txt.
FAMILIES = {
    "kerr_magnetosphere": (4, {3: (46149, 0), 4: (5889027, 0)},
                           {1: (9, 0), 2: (439, 0)}, ()),
    "laplace": (4, {3: (1813, 135), 4: (67110, 1462),
                    5: (2787664, 20154)},
                {1: (4, 2), 2: (61, 17)},
                ("Point charge (2D log potential)", "Saddle (Im z^2)",
                 "Uniform X")),
    "grad_shafranov": (4, {3: (2119, 47), 4: (82344, 496),
                           5: (3572019, 7378)},
                       {1: (4, 1), 2: (66, 7)},
                       ("Vertical flux", "X-point flux")),
}
# the Ω variant of force_free (--omega 1.0): its own residual, hence a
# fifth build of the four kernels
OMEGA = 1.0
OMEGA_TAG = "force_free@omega=1.0"   # its residual key
# phase 18: the JAX package's CLI on the CPU, ``python -m pde_engine_tpu
# --problem force_free --omega 1.0 --max-depth 4 --no-audit-rejects``
# (JAX_PLATFORMS=cpu): per depth (uniques, valid), and its knowns
OMEGA_JAX = {1: (5, 4), 2: (153, 85), 3: (8977, 2033), 4: (657067, 59664)}
OMEGA_KNOWNS = ("Vertical field", "X-point", "Radial", "Parabolic",
                "Hyperbolic")
# phase 19: the JAX tape engine on the CPU, ``DiscoveryEngine(
# load_problem("force_free"), SearchConfig(engine="tape", max_depth=3))
# .run(3)``: per depth (candidates, uniques, valid), the first 16 hex
# digits of the sha256 of the depth's row signatures, sorted and joined
# by newlines, and its knowns
TAPE_JAX = {1: (5, 5, 4), 2: (168, 151, 91), 3: (9835, 6665, 1474)}
TAPE_JAX_DIGEST = {1: "371942cd1edd4845", 2: "cd3a56bbe209d729",
                   3: "8cbae1519c42edf6"}
TAPE_KNOWNS = ("Parabolic", "Vertical field", "X-point")
# phase 21: the JAX package's CLI on the CPU (JAX_PLATFORMS=cpu), per
# depth (candidates, uniques, valid) and its knowns.  ``python -m
# pde_engine_tpu --problem force_free --no-special-ops --max-depth 4``:
NSO_JAX = {1: (5, 5, 4), 2: (112, 104, 68), 3: (4676, 4149, 1237),
           4: (229773, 200656, 26657)}
NSO_KNOWNS = ("Vertical field", "X-point", "Radial", "Dipolar", "Parabolic",
              "Bent")
SPECIAL_OPS = ("sqrt_shift_neg", "sqrt_shift_pos", "exp_mul", "log_mul")
# ``... --problem force_free --no-prune --max-depth 4 --no-audit-rejects``
# (depth 3 alone gives the same depths 1-3), and its knowns at depths 3, 4
NP_JAX = {1: (5, 5, 4), 2: (245, 202, 109), 3: (17776, 15588, 3515),
          4: (1698378, 1505634, 130220)}
NP_KNOWNS = {3: ("Vertical field", "X-point", "Parabolic"),
             4: ("Vertical field", "X-point", "Radial", "Dipolar",
                 "Parabolic", "Hyperbolic", "Bent")}
# ``... --problem laplace --max-depth 3 --mode sequential --heavy-checks``:
# its counts, knowns, and the count and ``funnel_digest`` of the
# ``funnel_rows`` of its DB (the rows that reached the symbolic stage)
SEQ_JAX = {1: (4, 4, 2), 2: (69, 61, 17), 3: (2193, 1813, 135)}
SEQ_KNOWNS = ("Point charge (2D log potential)", "Saddle (Im z^2)",
              "Uniform X")
SEQ_FUNNEL = (154, "ae4050d38559a569")
BUILD_SEEDS = {"laplace": 1, "kerr_magnetosphere": 2, "grad_shafranov": 3,
               OMEGA_TAG: 5}
AUDIT_LIMIT = 200   # rows of phase 10's verify, heavy and certify passes
# phase 10's kerr depth-2 run: its counts, and the JAX package's
# --find-monopole and --audit-kerr results on the CPU for the same rows
KERR_D2 = {1: (9, 0), 2: (439, 0)}
KERR_D2_MONOPOLE = 11
KERR_D2_TAGS = {"constant": 7, "no_r_dependence": 92, "no_x_dependence": 99,
                "disguised_monopole": 4, "other": 246}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str):
    print(msg, flush=True)


def smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def compare(out, ref, t=15):
    """(packed mismatches, fj mismatches, jets mismatches, max ulp of the
    point's largest coefficient, max abs err) of a kernel output against
    its reference (``t`` coefficients per point).  NaN equals NaN;
    everything else is compared by bits."""
    import numpy as np
    pk, js, fj = (t.cpu().numpy() for t in out)
    rp, rs, rf = (t.cpu().numpy() for t in ref)

    def neq(x, y):
        return ~((x.view(np.int32) == y.view(np.int32))
                 | (np.isnan(x) & np.isnan(y)))

    bad_p = int((pk != rp).any(axis=1).sum())
    bad_f = int(neq(fj, rf).any(axis=1).sum())
    bad_s = neq(js, rs)
    ulps = 0.0
    if bad_s.any():
        x = js.reshape(js.shape[0], -1, t)
        y = rs.reshape(rs.shape[0], -1, t)
        fin = np.isfinite(y)
        big = np.max(np.where(fin, np.abs(y), 0.0), axis=-1, keepdims=True)
        step = np.spacing(big.astype(np.float32)).astype(np.float64)
        d = np.abs(x.astype(np.float64) - y) / np.maximum(step, 1e-45)
        d = np.where(bad_s.reshape(x.shape) & fin & np.isfinite(x), d, 0.0)
        ulps = float(d.max())
        if (bad_s.reshape(x.shape) & ~(fin & np.isfinite(x))).any():
            ulps = float("inf")
    both = np.isfinite(js) & np.isfinite(rs)
    err = float(np.max(np.abs(js[both].astype(np.float64) - rs[both]),
                       initial=0.0))
    bf = np.isfinite(fj) & np.isfinite(rf)
    err = max(err, float(np.max(np.abs(fj[bf].astype(np.float64) - rf[bf]),
                                initial=0.0)))
    return bad_p, bad_f, int(bad_s.any(axis=1).sum()), ulps, err


def check(name, op_names, rows_per_op, out, ref, t=15):
    """Hold one kernel output against its reference, op by op
    (``op_names`` maps op ids to names; ``rows_per_op`` is each row's op
    id)."""
    import numpy as np
    if any(x.shape[0] != len(rows_per_op) for x in list(out) + list(ref)):
        fail(f"{name}: {[x.shape[0] for x in out]} rows out, "
             f"{[x.shape[0] for x in ref]} rows in the reference, "
             f"{len(rows_per_op)} expected")
    worst_err, worst_ulp, jet_rows = 0.0, 0.0, 0
    for op in np.unique(rows_per_op).tolist():
        sel = np.nonzero(rows_per_op == op)[0]
        bp, bf, bs, ulp, err = compare([x[sel] for x in out],
                                       [x[sel] for x in ref], t)
        opn = op_names[op]
        worst_err = max(worst_err, err)
        if bp or bf:
            fail(f"{name}/{opn}: {bp} packed and {bf} fingerprint rows "
                 "differ from the plain version")
        if bs and opn not in EXP_LOG_OPS:
            fail(f"{name}/{opn}: {bs} screen-jet rows differ")
        if bs:
            say(f"    {name}/{opn}: {bs} screen-jet rows differ, max "
                f"{ulp:.2f} ulp of the point's largest coefficient")
            if ulp > ULP_BOUND:
                fail(f"{name}/{opn}: {ulp} ulp > {ULP_BOUND}")
        worst_ulp = max(worst_ulp, ulp)
        jet_rows += bs
    return worst_err, worst_ulp, jet_rows


def time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn``'s kernels alone: ``reps`` calls
    captured into one CUDA graph and replayed back to back, so that no
    host work (checks, allocations, the launch call) sits between two
    launches, as it does in ``time_ms`` where a small launch takes less
    time than the host needs to issue it."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


IDLE_S = 0.005  # host time between two isolated launches


def isolated_ms(fn, kernel: str, reps: int = 10) -> float:
    """Median kernel window of ``fn``'s launch of ``kernel`` after the card
    has idled IDLE_S, timed as on the engine's paths (CUDA events just
    around the launcher, ``LaunchTimer``)."""
    import numpy as np
    import torch
    with LaunchTimer() as timer:
        for _ in range(reps):
            torch.cuda.synchronize()
            time.sleep(IDLE_S)
            fn()
    return float(np.median([ms for _, ms in timer.per_launch(kernel)]))


def idle_floor_ms(reps: int = 20) -> float:
    """Median window of CUDA events around one one-element add after the
    card has idled IDLE_S: the least an isolated launch reads on the
    paths."""
    import numpy as np
    import torch
    x = torch.zeros(1, device="cuda")
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        time.sleep(IDLE_S)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        x.add_(1.0)
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.median(out))


def round_trip_ms(fn, reps: int) -> float:
    """Host wall time of ``fn`` when it ends in a device-to-host copy."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def row_bytes(spec) -> int:
    """One cache row of the family: screen jets and fingerprint jets."""
    return 4 * (spec.sdim + spec.fdim)


def out_bytes(spec) -> int:
    """One candidate's outputs: jets, fingerprint jets, packed verdicts."""
    return 4 * (spec.sdim + spec.fdim + 3)


def bound(spec, n: int, rows, binary_rows, index_bytes: int, ops: float):
    """(bound_ms, bound_by) of one launch of the family of ``spec``: ``n``
    candidates reading the distinct cache rows of ``rows`` (every
    candidate's a row) and ``binary_rows`` (the b rows of binary ops),
    ``index_bytes`` of index arrays, writing ``out_bytes(spec)`` per
    candidate, doing ``ops`` float32 operations."""
    import torch
    distinct = int(torch.unique(torch.cat([rows.reshape(-1).long(),
                                           binary_rows.reshape(-1).long()
                                           ])).numel())
    t_bytes = (distinct * row_bytes(spec) + index_bytes
               + n * out_bytes(spec)) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ragged_ops(rng, n: int, n_ops: int):
    """Per-row op ids of ``n`` rows in runs of 1-199 rows, ops in turn:
    the runs end at any lane of a warp."""
    import numpy as np
    runs = rng.integers(1, 200, size=n)
    return np.repeat(np.arange(n) % n_ops, runs)[:n].astype(np.int32)


def phase_kernels(spec, dev):
    """Phase 3: every kernel against its plain version on the card."""
    import numpy as np
    import torch

    from pde_engine_tpu_torch.ops.cuda_emit import op_counts
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel import search
    from pde_engine_tpu_torch.parallel.incremental import OP_ORDER
    from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np
    from pde_engine_tpu_torch.models import load_problem

    problem = load_problem("force_free")
    rng = np.random.default_rng(0)
    C = 4 * SUPER
    T = 15
    s = rng.normal(0.0, 0.5, size=(C, spec.n_screen, T)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec.n_screen))
    f = rng.normal(0.0, 0.5, size=(C, spec.n_fp, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec.n_fp))
    f = snap_fp_jets_np(f.reshape(C, -1))
    cache_s = torch.from_numpy(s.reshape(C, -1)).to(dev)
    cache_f = torch.from_numpy(f).to(dev)
    sp = torch.as_tensor(problem.screen_points, dtype=torch.float32,
                         device=dev)
    fp = torch.as_tensor(problem.fingerprint_points, dtype=torch.float32,
                         device=dev)
    names = dict(enumerate(OP_ORDER))
    n_ops = len(OP_ORDER)
    n_tiles = SUPER // 512
    unary = ce.N_UNARY
    counts = op_counts(spec.order, search._RESIDUALS[spec.residual_key],
                       spec.n_screen, spec.n_fp)
    ops_of = torch.tensor([counts[nm] for nm in OP_ORDER],
                          dtype=torch.float64, device=dev)
    say(f"  float ops per candidate (emitted jet algebra + residual): "
        f"{min(counts.values())} ({min(counts, key=counts.get)}) to "
        f"{max(counts.values())} ({max(counts, key=counts.get)})")
    results = {}

    def binary_b(b_rows, row_ops):
        return b_rows[row_ops >= unary]

    # segmented: random operand rows, rows [512t, 512t + 512) run op
    # t % 18; the partial launch in ragged op runs
    ab = torch.from_numpy(rng.integers(0, C, size=(SUPER, 2),
                                       dtype=np.int32)).to(dev)
    rows_op = np.repeat(np.arange(n_tiles) % n_ops, 512).astype(np.int32)
    row_ops = torch.from_numpy(rows_op).to(dev)
    out = ce.segmented(spec, cache_s, cache_f, ab, row_ops, sp, fp)
    ref = ce.segmented_ref(spec, cache_s, cache_f, ab, row_ops, sp, fp)
    torch.cuda.synchronize()
    err, ulp, bad = check("segmented", names, rows_op, out, ref)
    rag = ragged_ops(rng, PARTIAL_ROWS, n_ops)
    part = (ab[:PARTIAL_ROWS], torch.from_numpy(rag).to(dev), sp, fp)
    check(f"segmented[{PARTIAL_ROWS} rows, ragged ops]", names, rag,
          ce.segmented(spec, cache_s, cache_f, *part),
          ce.segmented_ref(spec, cache_s, cache_f, *part))
    ms = time_ms(lambda: ce.segmented(spec, cache_s, cache_f, ab, row_ops,
                                      sp, fp), 10)
    plain = time_ms(lambda: ce.segmented_ref(spec, cache_s, cache_f, ab,
                                             row_ops, sp, fp), 2)
    b_ms, b_by = bound(spec, SUPER, ab[:, 0], binary_b(ab[:, 1], row_ops),
                       SUPER * 12, float(ops_of[row_ops.long()].sum()))
    results["segmented"] = (err, ulp, ms, plain, SUPER, bad, b_ms, b_by)

    # structured: every op, both kinds for binary ops; timed on two ops
    err_s, ulp_s, ms_s, plain_s, rows_s, bad_s = 0.0, 0.0, [], [], 0, 0
    bounds_s = []
    for op in range(n_ops):
        for big in (("a",) if op < unary else ("a", "b")):
            big0 = int(rng.integers(0, C - SUPER))
            const = int(rng.integers(0, C))
            if op == 0:  # the run ends at the cache's last row
                big0 = C - SUPER
            out = ce.structured(spec, cache_s, cache_f, const, big0, op, sp,
                                fp, big, SUPER)
            ref = ce.structured_ref(spec, cache_s, cache_f, const, big0, op,
                                    sp, fp, big, SUPER)
            torch.cuda.synchronize()
            e, u, b = check(f"structured[{big}]", names,
                            np.full(SUPER, op), out, ref)
            err_s, ulp_s = max(err_s, e), max(ulp_s, u)
            rows_s += SUPER
            bad_s += b
            if op in (unary - 1, n_ops - 1) and big == "a":
                ms_s.append(time_ms(lambda: ce.structured(
                    spec, cache_s, cache_f, const, big0, op, sp, fp, big,
                    SUPER), 10))
                plain_s.append(time_ms(lambda: ce.structured_ref(
                    spec, cache_s, cache_f, const, big0, op, sp, fp, big,
                    SUPER), 2))
                run = torch.arange(big0, big0 + SUPER, device=dev)
                cst = torch.tensor([const] if op >= unary else [],
                                   device=dev)
                bounds_s.append(bound(spec, SUPER, run, cst, 0,
                                      SUPER * float(ops_of[op])))
    # structured at its path's launch shape (--batch-size 4096): every
    # op and kind, timed
    ms_q, plain_q, bounds_q, graph_q, iso_q = [], [], [], [], []
    for op in range(n_ops):
        for big in (("a",) if op < unary else ("a", "b")):
            big0 = int(rng.integers(0, C - STRUCT_ROWS))
            const = int(rng.integers(0, C))
            if op % 2 == 0:  # the run ends at the cache's last row
                big0 = C - STRUCT_ROWS
            a = (const, big0, op, sp, fp, big, STRUCT_ROWS)
            e, u, b = check(f"structured[{big}, {STRUCT_ROWS} rows]", names,
                            np.full(STRUCT_ROWS, op),
                            ce.structured(spec, cache_s, cache_f, *a),
                            ce.structured_ref(spec, cache_s, cache_f, *a))
            err_s, ulp_s = max(err_s, e), max(ulp_s, u)
            rows_s += STRUCT_ROWS
            bad_s += b
            ms_q.append(time_ms(lambda: ce.structured(
                spec, cache_s, cache_f, *a), 50))
            graph_q.append(graph_ms(lambda: ce.structured(
                spec, cache_s, cache_f, *a), 50))
            iso_q.append(isolated_ms(lambda: ce.structured(
                spec, cache_s, cache_f, *a), "structured"))
            plain_q.append(time_ms(lambda: ce.structured_ref(
                spec, cache_s, cache_f, *a), 2))
            bounds_q.append(bound(
                spec, STRUCT_ROWS, torch.arange(big0, big0 + STRUCT_ROWS,
                                          device=dev),
                torch.tensor([const] if op >= unary else [], device=dev), 0,
                STRUCT_ROWS * float(ops_of[op]))[0])
    results["structured"] = (
        err_s, ulp_s, float(np.mean(ms_s)), float(np.mean(plain_s)), rows_s,
        bad_s, float(np.mean([b for b, _ in bounds_s])), bounds_s[0][1])
    shapes = {"structured": {
        "rows": STRUCT_ROWS, "ms": float(np.mean(ms_q)), "ms_min": min(ms_q),
        "ms_max": max(ms_q), "kernel_ms": float(np.mean(graph_q)),
        "isolated_ms": float(np.mean(iso_q)),
        "plain_ms": float(np.mean(plain_q)),
        "bound_ms": float(np.mean(bounds_q))}}
    say(f"  structured at its path's launch shape ({STRUCT_ROWS:,} rows, "
        f"every op and kind; the runs of even ops, and of op 0 at "
        f"{SUPER:,} rows, end at the cache's last row): 0 packed and 0 "
        "fingerprint-jet rows differ; "
        f"entry point back to back {shapes['structured']['ms']:.4f} "
        f"ms/launch ({min(ms_q):.4f}-{max(ms_q):.4f}); kernel alone (CUDA "
        f"graph) {np.mean(graph_q):.4f} ms ({min(graph_q):.4f}-"
        f"{max(graph_q):.4f}); isolated launch {np.mean(iso_q):.4f} ms; "
        f"plain {shapes['structured']['plain_ms']:.3f} ms; bound "
        f"{shapes['structured']['bound_ms']:.5f} ms")

    # tiled: per-tile op, kind and start; a zeroed pad tail of 40 tiles
    starts = rng.integers(0, C - 512, size=n_tiles).astype(np.int32)
    consts = rng.integers(0, C, size=n_tiles).astype(np.int32)
    ops_t = (np.arange(n_tiles) % n_ops).astype(np.int32)
    kinds = np.where(ops_t < unary, 0, (np.arange(n_tiles) // n_ops) % 2)
    opkind = (ops_t * 2 + kinds).astype(np.int32)
    pad = n_tiles - 40
    starts[pad:], consts[pad:], opkind[pad:] = 0, 0, 0
    ops_t[pad:] = 0
    args = [torch.from_numpy(a).to(dev) for a in (starts, consts, opkind)]
    out = ce.tiled(spec, cache_s, cache_f, *args, sp, fp, SUPER)
    ref = ce.tiled_ref(spec, cache_s, cache_f, *args, sp, fp, SUPER)
    torch.cuda.synchronize()
    err, ulp, bad = check("tiled", names, np.repeat(ops_t, 512), out, ref)
    part = (*(a[:PARTIAL_TILES] for a in args), sp, fp, PARTIAL_TILES * 512)
    check(f"tiled[{PARTIAL_TILES} tiles]", names,
          np.repeat(ops_t[:PARTIAL_TILES], 512),
          ce.tiled(spec, cache_s, cache_f, *part),
          ce.tiled_ref(spec, cache_s, cache_f, *part))
    ms = time_ms(lambda: ce.tiled(spec, cache_s, cache_f, *args, sp, fp,
                                  SUPER), 10)
    plain = time_ms(lambda: ce.tiled_ref(spec, cache_s, cache_f, *args, sp,
                                         fp, SUPER), 2)
    runs = (args[0].long()[:, None]
            + torch.arange(512, device=dev)[None, :])
    ops_tt = torch.from_numpy(ops_t).to(dev)
    b_ms, b_by = bound(spec, SUPER, runs, args[1][ops_tt >= unary],
                       3 * n_tiles * 4,
                       512 * float(ops_of[ops_tt.long()].sum()))
    results["tiled"] = (err, ulp, ms, plain, SUPER, bad, b_ms, b_by)

    # universal: one launch of SUPER random operand rows per op
    err_u, ulp_u, ms_u, plain_u, bad_u, bounds_u = 0.0, 0.0, [], [], 0, []
    for op in range(n_ops):
        ab_u = torch.from_numpy(rng.integers(0, C, size=(SUPER, 2),
                                             dtype=np.int32)).to(dev)
        out = ce.universal(spec, cache_s, cache_f, ab_u, op, sp, fp)
        ref = ce.universal_ref(spec, cache_s, cache_f, ab_u, op, sp, fp)
        torch.cuda.synchronize()
        e, u, b = check("universal", names, np.full(SUPER, op), out, ref)
        err_u, ulp_u, bad_u = max(err_u, e), max(ulp_u, u), bad_u + b
        ms_u.append(time_ms(lambda: ce.universal(
            spec, cache_s, cache_f, ab_u, op, sp, fp), 5))
        plain_u.append(time_ms(lambda: ce.universal_ref(
            spec, cache_s, cache_f, ab_u, op, sp, fp), 1))
        bounds_u.append(bound(spec, SUPER, ab_u[:, 0],
                              ab_u[:, 1] if op >= unary else ab_u[:0, 1],
                              SUPER * 8, SUPER * float(ops_of[op])))
        say(f"    universal/{names[op]}: {ms_u[-1]:.3f} ms kernel, "
            f"{plain_u[-1]:.3f} ms plain, bound {bounds_u[-1][0]:.4f} ms "
            f"({bounds_u[-1][1]})")
    # universal at the per-op path's launch shape (pipeline._eval_op_idx
    # launches exactly its candidates): PER_OP_ROWS candidates over the
    # depth <= 3 cache rows
    ms_p, plain_p, trip_p, bounds_p, graph_p, iso_p = [], [], [], [], [], []
    for op in range(n_ops):
        ab_np = rng.integers(0, DEPTH3_ROWS, size=(PER_OP_ROWS, 2),
                             dtype=np.int32)
        ab_p = torch.from_numpy(ab_np).to(dev)
        out = ce.universal(spec, cache_s, cache_f, ab_p, op, sp, fp)
        ref = ce.universal_ref(spec, cache_s, cache_f, ab_p, op, sp, fp)
        torch.cuda.synchronize()
        e, u, b = check("universal[per-op shape]", names,
                        np.full(PER_OP_ROWS, op), out, ref)
        err_u, ulp_u, bad_u = max(err_u, e), max(ulp_u, u), bad_u + b
        ms_p.append(time_ms(lambda: ce.universal(
            spec, cache_s, cache_f, ab_p, op, sp, fp), 50))
        graph_p.append(graph_ms(lambda: ce.universal(
            spec, cache_s, cache_f, ab_p, op, sp, fp), 50))
        iso_p.append(isolated_ms(lambda: ce.universal(
            spec, cache_s, cache_f, ab_p, op, sp, fp), "universal"))
        plain_p.append(time_ms(lambda: ce.universal_ref(
            spec, cache_s, cache_f, ab_p, op, sp, fp), 2))
        trip_p.append(round_trip_ms(lambda: ce.universal(
            spec, cache_s, cache_f, torch.from_numpy(ab_np).to(dev), op,
            sp, fp)[0].cpu(), 50))
        bounds_p.append(bound(spec, PER_OP_ROWS, ab_p[:, 0],
                              ab_p[:, 1] if op >= unary else ab_p[:0, 1],
                              PER_OP_ROWS * 8,
                              PER_OP_ROWS * float(ops_of[op]))[0])
    shapes["universal"] = per_op = {
        "rows": PER_OP_ROWS, "ms": float(np.mean(ms_p)), "ms_min": min(ms_p),
        "ms_max": max(ms_p), "kernel_ms": float(np.mean(graph_p)),
        "isolated_ms": float(np.mean(iso_p)),
        "plain_ms": float(np.mean(plain_p)),
        "round_trip_ms": float(np.mean(trip_p)),
        "bound_ms": float(np.mean(bounds_p))}
    floor = idle_floor_ms()
    for v in shapes.values():
        v["idle_floor_ms"] = floor
    say(f"  universal at the per-op launch shape ({PER_OP_ROWS:,} rows, "
        f"18 ops): 0 packed and 0 fingerprint-jet rows "
        f"differ; entry point back to back {per_op['ms']:.4f} ms/launch "
        f"({per_op['ms_min']:.4f}-{per_op['ms_max']:.4f} over the ops); "
        f"kernel alone (CUDA graph) {np.mean(graph_p):.4f} ms "
        f"({min(graph_p):.4f}-{max(graph_p):.4f}); isolated launch "
        f"{np.mean(iso_p):.4f} ms (a one-element add: {floor:.4f} ms); plain "
        f"{per_op['plain_ms']:.3f} ms, round trip (index upload, kernel, "
        f"verdict copy) {per_op['round_trip_ms']:.4f} ms; bound "
        f"{per_op['bound_ms']:.5f} ms")
    # ragged launches: the last block's rows end inside a warp
    for rows in RAGGED_ROWS:
        for op in range(n_ops):
            ab_r = torch.from_numpy(rng.integers(0, C, size=(rows, 2),
                                                 dtype=np.int32)).to(dev)
            e, u, b = check(f"universal[{rows} rows]", names,
                            np.full(rows, op),
                            ce.universal(spec, cache_s, cache_f, ab_r, op,
                                         sp, fp),
                            ce.universal_ref(spec, cache_s, cache_f, ab_r,
                                             op, sp, fp))
            err_u, ulp_u, bad_u = max(err_u, e), max(ulp_u, u), bad_u + b
    say(f"  universal at {', '.join(map(str, RAGGED_ROWS))} rows, 18 ops: "
        "0 packed and 0 fingerprint-jet rows differ")
    results["universal"] = (
        err_u, ulp_u, float(np.mean(ms_u)), float(np.mean(plain_u)),
        n_ops * (SUPER + PER_OP_ROWS + sum(RAGGED_ROWS)), bad_u,
        float(np.mean([b for b, _ in bounds_u])),
        "bytes" if all(by == "bytes" for _, by in bounds_u)
        else "operations")
    for k, (e, u, m, p, rows, bad, b_ms, b_by) in results.items():
        say(f"  {k:10s} all 18 ops, {rows:,} rows: 0 packed and 0 "
            f"fingerprint-jet rows differ, {bad} screen-jet rows differ "
            f"(max {u:.2f} ulp, exp/log ops only), max abs err {e:.3e}; "
            f"{m:.3f} ms/launch kernel vs {p:.3f} ms plain; bound "
            f"{b_ms:.4f} ms ({b_by}), {b_ms / m:.1%} of it reached")
    for k in GROUP_KERNELS:
        say(f"  {k}: {results[k][2]:.4f} ms; partial launch: 0 packed and "
            "0 fingerprint-jet rows differ")
    return results, shapes


def phase_family(tag, spec, dev, seed, problem=None):
    """Phase 3 on another build: an order-2 family's (laplace, kerr,
    grad_shafranov: T = 6), or the Ω build of force_free (``problem``
    given).  The four kernels against their plain twins on full launches
    and on partial or small ones, all 18 ops, at the problem's own
    points.  Returns (screen-jet rows that differ (exp and log ops only,
    within ULP_BOUND), max abs err, max ulp)."""
    import numpy as np
    import torch

    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel.incremental import OP_ORDER
    from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np

    problem = problem or load_problem(tag)
    rng = np.random.default_rng(seed)
    C, T = SUPER, spec.sdim // spec.n_screen
    s = rng.normal(0.0, 0.5, size=(C, spec.n_screen, T)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec.n_screen))
    f = rng.normal(0.0, 0.5, size=(C, spec.n_fp, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec.n_fp))
    cache_s = torch.from_numpy(s.reshape(C, -1)).to(dev)
    cache_f = torch.from_numpy(snap_fp_jets_np(f.reshape(C, -1))).to(dev)
    sp = torch.as_tensor(problem.screen_points, dtype=torch.float32,
                         device=dev)
    fp = torch.as_tensor(problem.fingerprint_points, dtype=torch.float32,
                         device=dev)
    names = dict(enumerate(OP_ORDER))
    n_ops = len(OP_ORDER)
    n_tiles = SUPER // 512
    ops_t = (np.arange(n_tiles) % n_ops).astype(np.int32)
    ab = torch.from_numpy(rng.integers(0, C, size=(SUPER, 2),
                                       dtype=np.int32)).to(dev)
    kinds = np.where(ops_t < ce.N_UNARY, 0, (np.arange(n_tiles) // 18) % 2)
    til = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, C - 512, size=n_tiles),
        rng.integers(0, C, size=n_tiles), ops_t * 2 + kinds)]
    rows_op = np.repeat(ops_t, 512)
    rag = ragged_ops(rng, PARTIAL_ROWS, n_ops)
    worst = [0, 0.0, 0.0]  # jet rows that differ, max abs err, max ulp

    def hold(name, rows_op_, out, ref):
        err, ulp, bad = check(name, names, rows_op_, out, ref, T)
        worst[:] = [worst[0] + bad, max(worst[1], err), max(worst[2], ulp)]

    for seg_ops, nt in ((rows_op, n_tiles), (rag, PARTIAL_TILES)):
        n = len(seg_ops)
        seg = (ab[:n], torch.from_numpy(seg_ops).to(dev), sp, fp)
        hold(f"{tag} segmented[{n} rows]", seg_ops,
             ce.segmented(spec, cache_s, cache_f, *seg),
             ce.segmented_ref(spec, cache_s, cache_f, *seg))
        tl = (*(a[:nt] for a in til), sp, fp, nt * 512)
        hold(f"{tag} tiled[{nt} tiles]", rows_op[:nt * 512],
             ce.tiled(spec, cache_s, cache_f, *tl),
             ce.tiled_ref(spec, cache_s, cache_f, *tl))
    for op in range(n_ops):
        for rows in (SUPER, PER_OP_ROWS) + RAGGED_ROWS:
            u = (ab[:rows], op, sp, fp)
            hold(f"{tag} universal[{rows} rows]", np.full(rows, op),
                 ce.universal(spec, cache_s, cache_f, *u),
                 ce.universal_ref(spec, cache_s, cache_f, *u))
        for big in (("a",) if op < ce.N_UNARY else ("a", "b")):
            for rows in (SUPER, STRUCT_ROWS):  # both runs end at row C - 1
                s_args = (int(rng.integers(0, C)), C - rows, op, sp, fp, big,
                          rows)
                hold(f"{tag} structured[{big}, {rows} rows]",
                     np.full(rows, op),
                     ce.structured(spec, cache_s, cache_f, *s_args),
                     ce.structured_ref(spec, cache_s, cache_f, *s_args))
    bad = worst[0]
    say(f"  {tag} build (order {spec.order}): segmented ({SUPER:,} rows; "
        f"{PARTIAL_ROWS:,} in ragged op runs), tiled ({n_tiles} and "
        f"{PARTIAL_TILES} tiles), universal ({SUPER:,}, {PER_OP_ROWS} and "
        f"{', '.join(map(str, RAGGED_ROWS))} rows) and structured "
        f"({SUPER:,} and {STRUCT_ROWS:,} rows, both kinds, runs ending at "
        "the cache's last row), all 18 ops: 0 packed and 0 "
        f"fingerprint-jet rows differ, {bad} screen-jet rows differ "
        f"(exp/log ops only, at most {worst[2]:.2f} ulp), max abs err "
        f"{worst[1]:.3e}")
    return tuple(worst)


def build_ms(builds, dev, problem, seed=4):
    """Milliseconds per 262,144-row launch of each kernel for each build
    of ``builds`` ({tag: spec}, all of one problem's widths: its points
    ``problem``'s, T jet coefficients a point), on the inputs of
    ``phase_kernels``'s timings at those widths (a seeded random cache of
    4 x 262,144 rows; segmented and tiled over all 18 ops by 512-row
    tiles, structured on two ops, universal once per op), timed in turns
    (first build, the others, then back) and averaged over the turns.
    Returns ({tag: {kernel: ms}}, {tag: {kernel: (bound_ms, bound_by)}})."""
    import numpy as np
    import torch

    from pde_engine_tpu_torch.ops.cuda_emit import op_counts
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel import search
    from pde_engine_tpu_torch.parallel.incremental import OP_ORDER
    from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np

    spec0 = next(iter(builds.values()))
    rng = np.random.default_rng(seed)
    C, T = 4 * SUPER, spec0.sdim // spec0.n_screen
    n_ops, unary = len(OP_ORDER), ce.N_UNARY
    s = rng.normal(0.0, 0.5, size=(C, spec0.n_screen, T)).astype(np.float32)
    s[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec0.n_screen))
    f = rng.normal(0.0, 0.5, size=(C, spec0.n_fp, 3)).astype(np.float32)
    f[..., 0] = rng.uniform(0.3, 1.5, size=(C, spec0.n_fp))
    cache_s = torch.from_numpy(s.reshape(C, -1)).to(dev)
    cache_f = torch.from_numpy(snap_fp_jets_np(f.reshape(C, -1))).to(dev)
    sp = torch.as_tensor(problem.screen_points, dtype=torch.float32,
                         device=dev)
    fp = torch.as_tensor(problem.fingerprint_points, dtype=torch.float32,
                         device=dev)
    n_tiles = SUPER // 512
    ab = torch.from_numpy(rng.integers(0, C, size=(SUPER, 2),
                                       dtype=np.int32)).to(dev)
    ops_t = (np.arange(n_tiles) % n_ops).astype(np.int32)
    row_ops = torch.from_numpy(np.repeat(ops_t, 512)).to(dev)
    kinds = np.where(ops_t < unary, 0, (np.arange(n_tiles) // n_ops) % 2)
    til = [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (
        rng.integers(0, C - 512, size=n_tiles),
        rng.integers(0, C, size=n_tiles), ops_t * 2 + kinds)]
    big0, const = int(rng.integers(0, C - SUPER)), int(rng.integers(0, C))

    def launches(spec):
        return {
            "segmented": [lambda: ce.segmented(spec, cache_s, cache_f, ab,
                                               row_ops, sp, fp)],
            "structured": [
                (lambda op=op: ce.structured(spec, cache_s, cache_f, const,
                                             big0, op, sp, fp, "a", SUPER))
                for op in (unary - 1, n_ops - 1)],
            "tiled": [lambda: ce.tiled(spec, cache_s, cache_f, *til, sp, fp,
                                       SUPER)],
            "universal": [(lambda op=op: ce.universal(spec, cache_s, cache_f,
                                                      ab, op, sp, fp))
                          for op in range(n_ops)]}

    tags = list(builds)
    order = tags + tags[:0:-1] + tags[:1]   # a, b, ..., b, a
    ms = {t: {k: [] for k in ce.KERNELS} for t in tags}
    for t in order:
        for k, fns in launches(builds[t]).items():
            ms[t][k].append(float(np.mean([time_ms(fn, 5) for fn in fns])))
    run = torch.arange(big0, big0 + SUPER, device=dev)
    bounds = {}
    for t, spec in builds.items():
        counts = op_counts(spec.order, search._RESIDUALS[spec.residual_key],
                           spec.n_screen, spec.n_fp)
        ops_of = torch.tensor([counts[nm] for nm in OP_ORDER],
                              dtype=torch.float64, device=dev)
        b_seg = bound(spec, SUPER, ab[:, 0], ab[:, 1][row_ops >= unary],
                      SUPER * 12, float(ops_of[row_ops.long()].sum()))
        runs = til[0].long()[:, None] + torch.arange(512, device=dev)
        ops_tt = torch.from_numpy(ops_t).to(dev)
        b_til = bound(spec, SUPER, runs, til[1][ops_tt >= unary],
                      3 * n_tiles * 4,
                      512 * float(ops_of[ops_tt.long()].sum()))
        b_str = [bound(spec, SUPER, run,
                       torch.tensor([const] if op >= unary else [],
                                    device=dev), 0, SUPER * float(ops_of[op]))
                 for op in (unary - 1, n_ops - 1)]
        b_uni = [bound(spec, SUPER, ab[:, 0],
                       ab[:, 1] if op >= unary else ab[:0, 1], SUPER * 8,
                       SUPER * float(ops_of[op])) for op in range(n_ops)]
        bounds[t] = {
            "segmented": b_seg, "tiled": b_til,
            "structured": (float(np.mean([b for b, _ in b_str])),
                           b_str[0][1]),
            "universal": (float(np.mean([b for b, _ in b_uni])),
                          "bytes" if all(by == "bytes" for _, by in b_uni)
                          else "operations")}
        say(f"  {t}: float ops per candidate {min(counts.values())} "
            f"({min(counts, key=counts.get)}) to {max(counts.values())} "
            f"({max(counts, key=counts.get)})")
    out = {t: {k: float(np.mean(v)) for k, v in d.items()}
           for t, d in ms.items()}
    for k in ce.KERNELS:
        say(f"  {k:10s} ms per {SUPER:,}-row launch, builds in turns "
            f"{' -> '.join(order)}: " + "; ".join(
                f"{t} {out[t][k]:.4f} ("
                + ", ".join(f"{x:.4f}" for x in ms[t][k])
                + f"; bound {bounds[t][k][0]:.4f}, {bounds[t][k][1]})"
                for t in tags))
    return out, bounds


class LaunchTimer:
    """CUDA events around every kernel launch while active, and the live
    rows of each: ``cuda_engine._library`` hands out a proxy whose four
    launchers record an event just before and just after the launch (the
    entry points' checks and output allocations stay outside the
    window).  On a card that idles between launches, as on the engine's
    paths, such a window holds the card's wake-up as well as the kernel;
    with ``trace`` the kernels' own device times are also read from the
    CUDA activity trace (CUPTI, through ``torch.profiler``)."""

    LAUNCHERS = {"pde_screen_segmented": ("segmented", 7),
                 "pde_screen_structured": ("structured", 9),
                 "pde_screen_tiled": ("tiled", 8),
                 "pde_screen_universal": ("universal", 7)}  # index of n

    def __init__(self, trace: bool = False):
        from pde_engine_tpu_torch.parallel import cuda_engine
        self.ce = cuda_engine
        self.orig = cuda_engine._library
        self.events = {k: [] for k in cuda_engine.KERNELS}
        self.rows = {k: 0 for k in cuda_engine.KERNELS}
        self.trace, self.trace_error = None, None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            self.trace = profile(activities=[ProfilerActivity.CUDA])

    def _proxy(self, lib):
        import torch
        timer = self

        class Timed:
            def __getattr__(self, name):
                fn = getattr(lib, name)
                if name not in timer.LAUNCHERS:
                    return fn
                kernel, n_at = timer.LAUNCHERS[name]

                def timed(*args):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    rc = fn(*args)
                    e1.record()
                    timer.events[kernel].append((e0, e1, int(args[n_at])))
                    timer.rows[kernel] += int(args[n_at])
                    return rc
                return timed
        return Timed()

    def __enter__(self):
        self.ce._library = lambda spec: self._proxy(self.orig(spec))
        if self.trace is not None:
            try:
                self.trace.__enter__()
            except (RuntimeError, AssertionError) as e:
                # no activity trace here: device times not measured
                self.trace, self.trace_error = None, str(e)
        return self

    def __exit__(self, *exc):
        if self.trace is not None:
            self.trace.__exit__(*exc)
        self.ce._library = self.orig

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b, _ in ev)
                for k, ev in self.events.items()}

    def per_launch(self, kernel):
        """[(live rows, kernel ms)] of each launch, in order."""
        return [(n, a.elapsed_time(b)) for a, b, n in self.events[kernel]]

    def device(self, kernel):
        """[(live rows, device ms)] of each launch from the activity trace,
        in order, or None (not measured) unless the trace holds exactly
        the launches the events saw."""
        from torch.autograd import DeviceType
        if self.trace is None or not self.events[kernel]:
            return None
        got = sorted((e for e in self.trace.events()
                      if e.device_type == DeviceType.CUDA
                      and f"{kernel}_kernel" in e.name),
                     key=lambda e: e.time_range.start)
        if len(got) != len(self.events[kernel]):
            return None
        return [(n, e.time_range.elapsed_us() / 1e3)
                for (_, _, n), e in zip(self.events[kernel], got)]

    def device_ms(self, kernel):
        """Summed device ms of ``kernel``'s launches, or None."""
        pairs = self.device(kernel)
        return None if pairs is None else sum(ms for _, ms in pairs)


SIZE_EDGES = (64, 512, 2048, 8192)  # launch-size classes of by_size


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def by_size(pairs):
    """Launches, rows and summed kernel ms of (rows, ms) launches, by
    launch size: up to 64 rows, 65-512, 513-2,048, 2,049-8,192, more."""
    out = {}
    for n, ms in pairs:
        k = next((f"<={e}" for e in SIZE_EDGES if n <= e),
                 f">{SIZE_EDGES[-1]}")
        t = out.setdefault(k, [0, 0, 0.0])
        t[0] += 1
        t[1] += n
        t[2] += ms
    return {k: {"launches": a, "rows": b, "ms": c}
            for k, (a, b, c) in out.items()}


def ptxas_report(log: str):
    """{entry point: (registers, static shared bytes, spill store bytes,
    spill load bytes)} from an nvcc -Xptxas -v log, and the spill bytes
    of every function."""
    import re
    table, spills, entry, props = {}, {}, None, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and props:
            spills[props] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers(?:, used \d+ barriers)?"
                      r"(?:, (\d+) bytes smem)?", ln)
        if m and entry:
            table[entry] = [int(m.group(1)), int(m.group(2) or 0)]
    out = {}
    for name in ("segmented", "structured", "tiled", "universal"):
        mangled = [e for e in table if f"{name}_kernel" in e]
        if len(mangled) != 1:
            fail(f"ptxas log has no single entry for {name}_kernel")
        regs, smem = table[mangled[0]]
        out[name] = (regs, smem, *spills.get(mangled[0], (0, 0)))
    return out, spills


def run_cli(extra, db_dir, problem="force_free", depth=4, log=None):
    """One CLI run; returns the report JSON it wrote.  The run's own
    output (its log and report text) is kept off the console, which
    shows what this script prints of it; with ``log`` a list, it goes
    into the list."""
    from pde_engine_tpu_torch.cli import main
    db = os.path.join(db_dir, "run.db")
    argv = ["--problem", problem, "--max-depth", str(depth), "--device",
            "cuda", "--db-path", db] + extra
    rc, out = captured(lambda: main(argv))
    if log is not None:
        log.append(out)
    if rc != 0:
        fail(f"cli.main returned {rc}")
    reports = sorted(f for f in os.listdir(db_dir)
                     if f.startswith("reproduction_") and f.endswith(".json"))
    if not reports:
        fail("the run wrote no report")
    with open(os.path.join(db_dir, reports[-1])) as fh:
        return json.load(fh)


def captured(fn):
    """(fn(), what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn()
    return out, buf.getvalue()


def db_rows(db, rep, cols, where=""):
    """Rows of a run's expressions table as tuples of ``cols``."""
    import sqlite3
    con = sqlite3.connect(db)
    table = "expressions_" + rep["run_id"].replace("-", "_")
    rows = con.execute(f"SELECT {cols} FROM {table} {where}").fetchall()
    con.close()
    return rows


def keyed_rows(db, rep):
    """{(depth, signature): (expression, is_valid, reason)} of a run."""
    return {(d, k): (e, bool(v), r) for d, k, e, v, r in db_rows(
        db, rep, "depth, signature, expression, is_valid, "
        "validation_reason")}


def same_rows(db_a, rep_a, db_b, rep_b, where=""):
    """Fail unless two runs hold the same rows (id, expression,
    signature, is_valid); returns the row count."""
    cols = "id, expression, signature, is_valid"
    a = set(db_rows(db_a, rep_a, cols, where))
    b = set(db_rows(db_b, rep_b, cols, where))
    if a != b:
        fail(f"rows {where or 'of all depths'} differ: {len(a - b)} only "
             f"in {rep_a['run_id']}, {len(b - a)} only in "
             f"{rep_b['run_id']}, e.g. {sorted(a ^ b)[:3]}")
    return len(a)


def verdict_diff(db_a, rep_a, db_b, rep_b, strict: bool = True):
    """Compare two runs' DBs key by key (a row's signature is its dedup
    key).  Returns ({depth: [keys in both, only in a, only in b, kept with
    another expression]}, [(depth, key, row_a, row_b) whose verdict
    differs]), a row being (expression, is_valid, reason).  Fails if a valid row's
    key is missing from the other run: rows whose fingerprint is not
    finite are keyed by structure, over parent uids that may be numbered
    in another order, but those rows are never valid.  With ``strict``
    off, nothing fails and only the table and the flips are returned."""
    a, b = keyed_rows(db_a, rep_a), keyed_rows(db_b, rep_b)
    for x, y in (((a, b), (b, a)) if strict else ()):
        lost = [dk for dk, r in x.items() if r[1] and dk not in y]
        if lost:
            fail(f"{len(lost)} valid keys are missing from the other run, "
                 f"e.g. {lost[:3]}")
    table, flips = {}, []
    for dk in set(a) | set(b):
        t = table.setdefault(dk[0], [0, 0, 0, 0])
        if dk not in b:
            t[1] += 1
        elif dk not in a:
            t[2] += 1
        else:
            t[0] += 1
            ra, rb = a[dk], b[dk]
            t[3] += ra[0] != rb[0]
            if ra[1] != rb[1]:
                flips.append((dk[0], dk[1], ra, rb))
    return dict(sorted(table.items())), sorted(flips)


def f64_relmax(expr: str, problem: str = "force_free") -> float:
    """The engine's float64 recheck of one expression as SymPy parses it
    (relative residual over the informative screen points).  SymPy
    normalises the spelling (``log_mul(1, exp(Y))`` becomes ``Y``), so
    this is the residual of the function, not of the kept tape."""
    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.pipeline import Candidate, DiscoveryEngine
    if problem not in _CPU_ENGINES:
        _CPU_ENGINES[problem] = DiscoveryEngine(load_problem(problem),
                                                device="cpu")
    eng = _CPU_ENGINES[problem]
    p = eng.problem
    cand = Candidate(depth=0, expr_str=expr, top_op="", has_var=True,
                     tape=p.parse(expr), consts=p.consts)
    return eng._recheck_f64(cand)[1]


_CPU_ENGINES = {}


def counts_of(report):
    return {int(d): (v["generated"], v["valid"])
            for d, v in report["by_depth"].items()}


def stage_lines(report, card):
    """One line per depth: counts and the stage split; below each depth
    from 2 on, its ingest sections (PDE_INGEST_TIMERS), which must be
    there and sum to no more than its t_ingest."""
    for st in report["stats"]:
        if not st["seconds"]:
            continue  # a depth restored by a resume
        rate = st["candidates"] / st["seconds"]
        say(f"    depth {st['depth']}: {st['candidates']} candidates, "
            f"{st['unique']} unique, {st['valid']} valid | wall "
            f"{st['seconds']:.3f} s enum {st['t_enum']:.3f} device "
            f"{st['t_device']:.3f} ingest {st['t_ingest']:.3f} gray "
            f"{st['t_gray']:.3f} | {rate:,.0f} candidates/s on {card}")
        if st["depth"] < 2:
            continue  # depth 1 goes through the float64 oracle
        sec = st.get("ingest_sections") or {}
        total = sum(sec.values())
        if not sec or total > st["t_ingest"]:
            fail(f"depth {st['depth']}: ingest sections {sec} (sum "
                 f"{total:.3f} s) against t_ingest {st['t_ingest']:.3f} s")
        say("      ingest breakdown: " + " ".join(
            f"{k} {v:.3f}" for k, v in sec.items())
            + f" (sum {total:.3f} of {st['t_ingest']:.3f} s); outside "
            "the timed sections "
            f"{st['seconds'] - st['t_enum'] - st['t_device'] - st['t_ingest'] - st['t_gray']:.3f} s")


def check_main(report, card):
    counts = counts_of(report)
    found = sorted(report["paper_solutions_found"])
    if len(found) != 7:
        fail(f"{len(found)}/7 known solutions found: {found}")
    for d, want in EXACT.items():
        if counts.get(d) != want:
            fail(f"depth {d} counts {counts.get(d)} != {want}")
    for d, (u_ref, v_ref) in TPU_REF.items():
        u, v = counts[d]
        if abs(u - u_ref) > 0.01 * u_ref or abs(v - v_ref) > 0.01 * v_ref:
            fail(f"depth {d} counts {(u, v)} not within 1% of the TPU "
                 f"run's {(u_ref, v_ref)}")
    stage_lines(report, card)
    return counts


def api_run(db_dir, depth, resume_of=None, log=None, problem="force_free",
            mesh=None, **cfg):
    """A DiscoveryRun through the library entry points (the per-op path
    has no CLI flag, as in the JAX package); with ``resume_of`` a run id,
    the run is resumed and extended to ``depth`` (with ``log`` a list,
    the resume's rebuild log goes into it).  Returns (report, launches of
    the resume's cache rebuild or None)."""
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.runtime import DiscoveryRun
    from pde_engine_tpu_torch.utils.config import SearchConfig
    kw = dict(config=SearchConfig(max_depth=depth, **cfg),
              db_path=os.path.join(db_dir, "run.db"), device="cuda",
              verbose=False, report_families=False, mesh=mesh)
    seeded = None
    if resume_of is None:
        run = DiscoveryRun(problem, **kw)
        rep = run.run(depth)
    else:
        ce.reset_launch_counts()
        kw["verbose"] = log is not None
        run, out = captured(lambda: DiscoveryRun.resume(
            problem, resume_of, **kw))
        run.verbose = False
        if log is not None:
            log.append(out)
        seeded = dict(ce.LAUNCHES)
        ce.reset_launch_counts()
        rep = run.continue_run(depth)
    run.close()
    return rep, seeded


def phase_families(tmp, card):
    """Phase 9: kerr, laplace and grad_shafranov to depth 4
    through ``cli.main`` on the card, every launch traced; returns each
    run's summary."""
    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    out = {}
    for tag, (depth, tpu, exact, knowns) in FAMILIES.items():
        d = os.path.join(tmp, f"p9_{tag}")
        os.makedirs(d)
        say(f"  {tag} --max-depth {depth}:")
        log = []
        with LaunchTimer(trace=True) as timer:
            ce.reset_launch_counts()
            rep = run_cli([], d, problem=tag, depth=depth, log=log)
            launches = dict(ce.LAUNCHES)
        counts = counts_of(rep)
        for dd, want in exact.items():
            if counts.get(dd) != want:
                fail(f"{tag} depth {dd} counts {counts.get(dd)} != {want}")
        for dd, (u_ref, v_ref) in tpu.items():
            if dd > depth:
                continue
            u, v = counts[dd]
            if abs(u - u_ref) > 0.01 * u_ref or abs(v - v_ref) > 0.01 * v_ref:
                fail(f"{tag} depth {dd} counts {(u, v)} not within 1% of "
                     f"the TPU run's {(u_ref, v_ref)}")
        found = set(rep["paper_solutions_found"])
        if not set(knowns) <= found:
            fail(f"{tag}: knowns {sorted(set(knowns) - found)} not found")
        if tag == "kerr_magnetosphere":
            ok, rel, note = load_problem(tag).validate_known("1 - x")
            anchored = "Monopole" in log[0] and "[at anchor a→0]" in log[0]
            if not (ok and anchored):
                fail(f"kerr monopole not validated at its anchor: {ok} "
                     f"{rel} {note}")
            say(f"    monopole 1 - x valid at its anchor a→0 (max relres "
                f"{rel:.2e}); run log: " + next(
                    ln.strip() for ln in log[0].splitlines()
                    if "Monopole" in ln))
        stage_lines(rep, card)
        dev_ms = {k: timer.device_ms(k) for k in ce.KERNELS
                  if timer.events[k]}
        if not dev_ms or any(launches[k] <= 0 for k in dev_ms):
            fail(f"{tag}: no kernel launch on the card: {launches}")
        out[tag] = {
            "depth": depth, "counts": counts, "knowns": sorted(found),
            "launches": launches, "rows": dict(timer.rows),
            "event_ms": {k: v for k, v in timer.ms().items() if v},
            "device_ms": dev_ms, "wall_s": rep["wall_seconds"],
            "stages": [{k: st[k] for k in ("depth", "candidates", "unique",
                                             "valid", "seconds", "t_enum",
                                             "t_device", "t_ingest",
                                             "t_gray", "ingest_sections")}
                       for st in rep["stats"]]}
        say(f"    counts {counts}; knowns {sorted(found)}; launches "
            f"{launches}; kernel device ms (activity trace) "
            + ", ".join(f"{k} {fmt_ms(v)}" for k, v in dev_ms.items())
            + f"; wall {rep['wall_seconds']:.1f} s")
    return out


def report_of(text: str):
    """(per-depth (generated, valid), known names found) of a report
    printed by format_report_text."""
    import re
    counts = {int(d): (int(g), int(v)) for d, g, v in re.findall(
        r"depth (\d+):\s+(\d+) generated,\s+(\d+) valid", text)}
    return counts, set(re.findall(r"\[FOUND\] (.+?)  via ", text))


def phase_posthoc(rep4, d4, d10):
    """Phase 10: the audits of the port's CLI on phase 4's run DB, and on
    a kerr depth-2 run."""
    import re

    from pde_engine_tpu_torch.cli import main as cli
    db4 = os.path.join(d4, "run.db")
    t0 = time.time()
    rc, text = captured(lambda: cli([
        "--problem", "force_free", "--device", "cuda", "--db-path", db4,
        "--print-run-id", rep4["run_id"], "--verify-pde", "--verify-scope",
        "valid", "--verify-limit", str(AUDIT_LIMIT), "--heavy-validate",
        "--heavy-limit", str(AUDIT_LIMIT), "--certify", "--certify-limit",
        str(AUDIT_LIMIT), "--no-report-families"]))
    if rc != 0:
        fail(f"--print-run-id returned {rc}")
    counts, found = report_of(text)
    if counts != counts_of(rep4) or found != set(
            rep4["paper_solutions_found"]):
        fail(f"--print-run-id report {counts} {sorted(found)} != phase 4's "
             f"{counts_of(rep4)} {sorted(rep4['paper_solutions_found'])}")
    m = re.search(r"verify-pde \[valid\]: (\d+) confirmed, (\d+) refuted, "
                  r"(\d+) skipped", text)
    if not m or int(m.group(2)) or int(m.group(1)) + int(m.group(3)) != \
            AUDIT_LIMIT:
        fail(f"verify-pde: {m and m.group(0)}")
    h = re.search(r"heavy-validate \[valid\]: (\d+) passed, (\d+) failed",
                  text)
    c = re.search(r"certify \[valid\]: (\d+) certificates (\{.*?\}) -> "
                  r"(\S+)", text)
    if not h or not c or int(c.group(1)) != AUDIT_LIMIT:
        fail(f"heavy-validate / certify: {h and h.group(0)}, "
             f"{c and c.group(0)}")
    cert_counts = json.loads(c.group(2).replace("'", '"'))
    if cert_counts.get("refuted"):
        fail(f"certify refuted rows: {cert_counts}")
    t_audit = time.time() - t0
    t0 = time.time()
    r = subprocess.run([sys.executable,
                        os.path.join("tools", "check_certificates.py"),
                        c.group(3)], capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        fail(f"tools/check_certificates.py: {r.stdout[-2000:]}"
             f"{r.stderr[-2000:]}")
    say(f"  --print-run-id {rep4['run_id']}: report equals phase 4's "
        f"({counts}, {len(found)} knowns); {m.group(0)}; {h.group(0)}; "
        f"{c.group(0).split(' -> ')[0]}; {t_audit:.1f} s; "
        f"tools/check_certificates.py: {r.stdout.strip().splitlines()[0]} "
        f"({time.time() - t0:.1f} s)")
    rep = run_cli(["--no-report-families"], d10,
                  problem="kerr_magnetosphere", depth=2)
    t0 = time.time()
    rc, text = captured(lambda: cli([
        "--problem", "kerr_magnetosphere", "--device", "cuda", "--db-path",
        os.path.join(d10, "run.db"), "--print-run-id", rep["run_id"],
        "--find-monopole", "--audit-kerr", "--verify-scope", "all",
        "--no-report-families"]))
    if rc != 0:
        fail(f"kerr --print-run-id returned {rc}")
    counts, _ = report_of(text)
    mono = re.search(r"find-monopole \[all, target=either\]: (\d+) "
                     r"candidates", text)
    tags = dict((k, int(v)) for k, v in re.findall(
        r"audit-kerr \[all\] (\w+): (\d+)", text))
    if (counts != KERR_D2 or not mono or tags != KERR_D2_TAGS
            or int(mono.group(1)) != KERR_D2_MONOPOLE):
        fail(f"kerr audits: counts {counts}, {mono and mono.group(0)}, "
             f"tags {tags}; want {KERR_D2}, {KERR_D2_MONOPOLE} monopole "
             f"candidates, {KERR_D2_TAGS}")
    say(f"  kerr depth 2 ({sum(u for u, _ in counts.values())} rows): "
        f"{mono.group(0)}; audit-kerr {tags} (the JAX package's on the "
        f"CPU); {time.time() - t0:.1f} s")


def drop_sidecar(d):
    """Remove a run's registry sidecar (manifest and parts)."""
    db = os.path.join(d, "run.db")
    os.remove(db + ".registry.npz")
    shutil.rmtree(db + ".registry.d")


def ingest_beside(rep, ref, ref_tag="phase 4's", depth=4):
    """One line: a resumed run's depth-``depth`` stage and ingest
    sections (PDE_INGEST_TIMERS) beside those of the fresh run ``ref``."""
    def stage(r):
        return next(st for st in r["stats"] if st["depth"] == depth)
    a, f = stage(rep), stage(ref)
    sa, sf = a.get("ingest_sections") or {}, f.get("ingest_sections") or {}
    say(f"    depth {depth} resumed / {ref_tag} fresh: stage "
        f"{a['seconds']:.3f} / {f['seconds']:.3f} s, ingest "
        f"{a['t_ingest']:.3f} / {f['t_ingest']:.3f} s; "
        + " ".join(f"{k} {sa.get(k, 0.0):.3f} / {v:.3f}"
                   for k, v in sf.items()))


def null_struct(d, rep):
    """Make a run's DB as old as the struct columns: every triple NULL."""
    import sqlite3
    con = sqlite3.connect(os.path.join(d, "run.db"))
    table = "expressions_" + rep["run_id"].replace("-", "_")
    con.execute(f"UPDATE {table} SET struct_op=NULL, struct_a=NULL, "
                "struct_b=NULL")
    con.commit()
    con.close()


def phase_db_resume(d4, rep4, d6, rep6, d11a, rep7a, d11b, rep8a, d11c):
    """Phase 11: phase 7's and phase 8's depth-3 runs, their registry
    sidecars removed, resumed to depth 4 from their DB rows; then phase
    7's run as old as the struct columns (every triple NULL, no jet
    snapshot), whose rebuild takes the triples from the spellings and
    replays the cache through the kernels.  Returns the launch counts of
    (c)'s replay and of its depth 4."""
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    drop_sidecar(d11a)
    log = []
    ce.reset_launch_counts()
    rep = run_cli(["--resume-run", rep7a["run_id"], "--no-report-families"],
                  d11a, log=log)
    launches = dict(ce.LAUNCHES)
    fast = [ln for ln in log[0].splitlines()
            if "resume: structural fast path" in ln]
    if not fast or "from its DB rows" not in log[0]:
        fail("the DB-rebuild resume did not take the structural fast "
             "path: " + log[0][:2000])
    if counts_of(rep) != counts_of(rep4):
        fail(f"DB-rebuild resume counts {counts_of(rep)} != phase 4's "
             f"{counts_of(rep4)}")
    n = same_rows(os.path.join(d4, "run.db"), rep4,
                  os.path.join(d11a, "run.db"), rep, "WHERE depth = 4")
    say(f"  (a) CLI, jet snapshot: {fast[0].strip()}; depth-4 rows equal "
        f"phase 4's row for row ({n:,} rows); launches {launches}; wall "
        f"{rep['wall_seconds']:.1f} s")
    ingest_beside(rep, rep4)
    drop_sidecar(d11b)
    log = []
    cfg = dict(use_segmented=False, snapshot_jets=False)
    rep, seeded = api_run(d11b, 4, resume_of=rep8a["run_id"], log=log,
                          **cfg)
    fast = [ln for ln in log[0].splitlines()
            if "resume: structural fast path" in ln]
    if not fast or seeded["universal"] <= 0:
        fail(f"per-op DB-rebuild resume: {log[0][:2000]} {seeded}")
    n = same_rows(os.path.join(d6, "run.db"), rep6,
                  os.path.join(d11b, "run.db"), rep)
    say(f"  (b) per-op, no jet snapshot: {fast[0].strip()}; "
        f"{seeded['universal']} universal launches replaying the cache; "
        f"rows equal phase 6's row for row ({n:,} rows); wall "
        f"{rep['wall_seconds']:.1f} s")
    ingest_beside(rep, rep6, "phase 6's (per-op)")
    drop_sidecar(d11c)
    shutil.rmtree(os.path.join(d11c, "run.db.jets.d"))
    null_struct(d11c, rep7a)
    seed = DiscoveryEngine.seed_cache_from_uniques
    replay = {}

    def counted(eng, *a, **kw):
        before = dict(ce.LAUNCHES)
        try:
            return seed(eng, *a, **kw)
        finally:
            replay.update({k: ce.LAUNCHES[k] - before[k] for k in before})
    DiscoveryEngine.seed_cache_from_uniques = counted
    log = []
    try:
        ce.reset_launch_counts()
        rep = run_cli(["--resume-run", rep7a["run_id"],
                       "--no-report-families"], d11c, log=log)
        resumed = {k: v - replay.get(k, 0) for k, v in ce.LAUNCHES.items()}
    finally:
        DiscoveryEngine.seed_cache_from_uniques = seed
    parse = [ln.strip() for ln in log[0].splitlines()
             if "resume: parse path:" in ln]
    if not parse or not parse[0].endswith(", 0 as leaves"):
        fail("the parse-path resume did not re-register every composed "
             "row from its spelling: " + log[0][:2000])
    if sum(replay.values()) < 1:
        fail(f"the parse-path resume's cache replay launched {replay}")
    if counts_of(rep) != counts_of(rep4):
        fail(f"parse-path resume counts {counts_of(rep)} != phase 4's "
             f"{counts_of(rep4)}")
    n = same_rows(os.path.join(d4, "run.db"), rep4,
                  os.path.join(d11c, "run.db"), rep, "WHERE depth = 4")
    say(f"  (c) CLI, struct columns NULL, no jet snapshot: {parse[0]}; "
        f"replay launches {replay}; depth-4 rows equal phase 4's row for "
        f"row ({n:,} rows); depth-4 launches {resumed}; wall "
        f"{rep['wall_seconds']:.1f} s")
    ingest_beside(rep, rep4)
    return replay, resumed


class DepthLaunches:
    """While active, the entry points' launch counts made in each depth
    of the segmented path (``DiscoveryEngine._run_depth_segmented``; with
    ``method="_run_depth_per_op"`` the per-op path), by depth, in
    ``by_depth``."""

    def __init__(self, method: str = "_run_depth_segmented"):
        from pde_engine_tpu_torch.pipeline import DiscoveryEngine
        self.engine = DiscoveryEngine
        self.method = method
        self.orig = getattr(DiscoveryEngine, method)
        self.by_depth = {}

    def __enter__(self):
        from pde_engine_tpu_torch.parallel import cuda_engine as ce
        orig, by_depth = self.orig, self.by_depth

        def run_depth(eng, depth, *a, **kw):
            before = dict(ce.LAUNCHES)
            try:
                return orig(eng, depth, *a, **kw)
            finally:
                by_depth[depth] = {k: ce.LAUNCHES[k] - before[k]
                                   for k in before}
        setattr(self.engine, self.method, run_depth)
        return self

    def __exit__(self, *exc):
        setattr(self.engine, self.method, self.orig)


def run_bench(tmp, tag, seed_depth, depth_st, depth_launches, timeout):
    """``python -m pde_engine_tpu_torch.bench <seed_depth>`` at the
    default batch in a process of its own, with a HOME of its own so that
    its seed is made afresh and left in ``tmp``.  Checks: one JSON line
    with the JAX bench's keys; the whole stream, of the candidates of
    the engine's depth ``seed_depth + 1`` (``depth_st``, its stage) in
    the launches of each kind that depth made (``depth_launches``); the
    first launch of each kind bit-equal to its plain twin; the bench's
    own launch counts (set to 0 after its seed, before its warm-up)
    those of one warm-up launch of each kind routed and REPS + 1 runs of
    the stream (the timed ones and the traced one); the kernels' and
    the verdict copies' device ms read from the activity trace.
    Returns the line."""
    env = dict(os.environ, HOME=os.path.join(tmp, f"{tag}_home"))
    for k in ("PDE_BENCH_BATCH", "PDE_BENCH_MAX_SUPERS"):
        env.pop(k, None)
    r = subprocess.run([sys.executable, "-m", "pde_engine_tpu_torch.bench",
                        str(seed_depth)], capture_output=True, text=True,
                       env=env, timeout=timeout,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    rc, text = r.returncode, r.stdout
    say("  " + "\n  ".join(r.stderr.strip().splitlines()[-4:]))
    lines = text.splitlines()
    if rc != 0 or len(lines) != 1:
        fail(f"the bench returned {rc} and printed {len(lines)} lines: "
             f"{text[-2000:]}")
    res = json.loads(lines[0])
    if not {"metric", "value", "unit", "vs_baseline"} <= set(res):
        fail(f"the bench line lacks keys: {sorted(res)}")
    det = res["detail"]
    if det["candidates_timed"] != depth_st["candidates"] \
            or det["stream_truncated"]:
        fail(f"the bench timed {det['candidates_timed']} candidates "
             f"(truncated: {det['stream_truncated']}), the engine's depth "
             f"{depth_st['depth']} has {depth_st['candidates']}")
    routed = det["launches"]
    if routed != {k: depth_launches[k] for k in routed}:
        fail(f"the bench routed {routed}, the engine's depth "
             f"{depth_st['depth']} launched {depth_launches}")
    kinds = {k for k, n in routed.items() if n}
    differ = det["first_launch_rows_differ"] or {}
    if set(differ) != kinds or any(differ.values()):
        fail(f"first launch of each kind against its plain twin: rows "
             f"differing {differ}, kinds launched {sorted(kinds)}")
    launches = det["kernel_launches"]
    want = {k: routed.get(k, 0) * (det["reps"] + 1)
            + (1 if routed.get(k) else 0) for k in launches}
    if launches != want:
        fail(f"bench: kernel launches {launches}, want {want} (one warm-up "
             f"launch and {det['reps'] + 1} runs of {routed})")
    if det["kernel_device_ms"] is None or det["copy_device_ms"] is None:
        fail(f"bench: the activity trace read no device time "
             f"(events {det.get('trace_events')})")
    say(f"  one line; {det['candidates_timed']:,} candidates (the engine's "
        f"depth {depth_st['depth']}), launches {routed} (the engine's), "
        f"capacity slack {det['capacity_slack_rows']:,} rows, first launch "
        f"of each kind bit-equal to its plain twin ({differ}); value "
        f"{res['value']:,.0f} {res['unit']} (median of {det['reps']}: "
        f"{det['seconds']}); kernel device ms "
        f"{fmt_ms(det['kernel_device_ms'])} "
        f"({det.get('kernel_device_ms_by_kernel')}), verdict copies "
        f"{fmt_ms(det['copy_device_ms'])} ms ({det['verdict_bytes']:,} B)"
        f"; seed {det['seed_seconds']:.1f} s (cache hit: "
        f"{det['seed_cache_hit']}; its launches "
        f"{det['seed_kernel_launches']}); kernel launches {launches}; "
        f"{det['card']}")
    return res


def phase_bench(tmp, rep4, d4_launches):
    """Phase 12: the bench at seed depth 3 (the depth-4 stream at the
    default batch) against phase 4's depth 4 (``run_bench``).  Returns
    the result and the bench's launch counts."""
    st4 = next(st for st in rep4["stats"] if st["depth"] == 4)
    res = run_bench(tmp, "p12", 3, st4, d4_launches, 900)
    return res, res["detail"]["kernel_launches"]


def phase_canary(card, c4):
    """Phase 13: the recall canaries in a no-audit force_free depth-4 run
    through ``DiscoveryEngine`` (the port of tests/test_recall_canary.py):
    7/7 knowns, every canary a valid row whose dedup key maps back to its
    uid, and, with phase 4 run, phase 4's counts.  Returns the launch
    counts and, for phase 22, the engine's ``summary()``, its launched
    rows and oracle rows, and the rows its launches counted."""
    from pde_engine_tpu_torch import canary
    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    from pde_engine_tpu_torch.utils.config import SearchConfig
    t0 = time.time()
    eng = DiscoveryEngine(load_problem("force_free"), SearchConfig(
        max_depth=4, audit_rejects=False), device="cuda")
    with LaunchTimer() as timer:
        ce.reset_launch_counts()
        eng.run(4)
        launches = dict(ce.LAUNCHES)
    counts = {s.depth: (s.unique, s.valid) for s in eng.stats}
    found = {r.paper_solution_name for r in eng.valid_rows
             if r.paper_solution_name}
    if len(found) != 7:
        fail(f"no-audit depth 4: {len(found)}/7 knowns {sorted(found)}")
    if c4 is not None and counts != c4:
        fail(f"no-audit depth-4 counts {counts} != phase 4's {c4}")
    if eng.rows and not all(r.is_valid for r in eng.rows):
        fail("the no-audit run kept reject rows")
    stage_lines({"stats": [vars(s) for s in eng.stats]}, card)
    for expr, depth in canary.CANARIES:
        row = canary.locate(eng, expr)
        if row is None or not row.is_valid:
            fail(f"canary {expr} (depth {depth}) was not recovered as a "
                 "valid row")
        say(f"  canary {expr} (depth {depth}): valid row {row.id} "
            f"{row.expression!r} at depth {row.depth}, key "
            f"{row.signature} maps to its uid")
    say(f"  7/7 knowns; counts {counts}"
        + ("" if c4 is None else " (phase 4's)")
        + f"; launches {launches}; {time.time() - t0:.1f} s")
    return launches, {
        "summary": eng.summary(),
        "stats": [{k: v for k, v in vars(s).items() if k != "span_events"}
                  for s in eng.stats],
        "valid_rows": len(eng.valid_rows),
        "launched_rows": eng.launched_rows(), "timer_rows": dict(timer.rows),
        "oracle_rows": eng.stats[0].candidates
        + len(eng.problem.known_solutions)}


def phase_omega(tmp, card):
    """Phase 18: the Ω variant through the CLI on the card: ``--omega 1.0
    --max-depth 4 --no-audit-rejects`` on the default path, held to the
    JAX package's CPU counts (depths 1-2 exact, 3-4 within 1%) and knowns;
    the per-op path to depth 3 and ``--batch-size 4096`` to depth 4, so
    that each of the four kernels of the Ω build is launched; then
    ``--print-run-id <id> --omega 1.0 --verify-pde`` on the depth-4 DB,
    where no valid row may be refuted.  Returns the summary for the
    kernels line."""
    import re

    from pde_engine_tpu_torch.cli import main as cli
    from pde_engine_tpu_torch.models.force_free import ForceFreeProblem
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    dirs = [os.path.join(tmp, f"p18{x}") for x in "abc"]
    for d in dirs:
        os.makedirs(d)
    omega = ["--omega", str(OMEGA), "--no-audit-rejects",
             "--no-report-families"]
    out = {"launches": {}}
    with LaunchTimer(trace=True) as timer:
        ce.reset_launch_counts()
        rep = run_cli(omega, dirs[0])
        out["launches"]["main"] = launches = dict(ce.LAUNCHES)
    counts = counts_of(rep)
    found = set(rep["paper_solutions_found"])
    for d, want in OMEGA_JAX.items():
        u, v = counts.get(d, (0, 0))
        tol = 0 if d <= 2 else 0.01
        if abs(u - want[0]) > tol * want[0] or \
                abs(v - want[1]) > tol * want[1]:
            fail(f"Ω depth {d} counts {(u, v)} against the JAX package's "
                 f"{want} (tolerance {tol:.0%})")
    if found != set(OMEGA_KNOWNS):
        fail(f"Ω knowns {sorted(found)} != the JAX package's "
             f"{sorted(OMEGA_KNOWNS)}")
    if launches["segmented"] <= 0 or launches["tiled"] <= 0:
        fail(f"the Ω run's default path launched {launches}")
    stage_lines(rep, card)
    say(f"  --omega {OMEGA} --max-depth 4: counts {counts} (the JAX "
        f"package on the CPU: {OMEGA_JAX}); knowns {sorted(found)}; "
        f"launches {launches}; kernel device ms (activity trace) "
        + ", ".join(f"{k} {fmt_ms(timer.device_ms(k))}"
                    for k in ("segmented", "tiled"))
        + f"; wall {rep['wall_seconds']:.1f} s")
    out.update(counts=counts, wall_s=rep["wall_seconds"],
               device_ms={k: timer.device_ms(k) for k in ce.KERNELS
                          if timer.events[k]},
               stages=[{k: st[k] for k in ("depth", "candidates", "unique",
                                             "valid", "seconds", "t_enum",
                                             "t_device", "t_ingest",
                                             "t_gray")}
                       for st in rep["stats"]])

    ce.reset_launch_counts()
    rep3, _ = api_run(dirs[1], 3, problem=ForceFreeProblem(omega=OMEGA),
                      use_segmented=False)
    out["launches"]["per_op_d3"] = l3 = dict(ce.LAUNCHES)
    c3 = counts_of(rep3)
    if l3["universal"] <= 0 or any(l3[k] for k in ("segmented", "structured",
                                                   "tiled")):
        fail(f"the Ω per-op run launched {l3}: want universal only")
    for d in (1, 2, 3):
        if abs(c3[d][0] - counts[d][0]) > VALID_SPREAD * counts[d][0] or \
                abs(c3[d][1] - counts[d][1]) > VALID_SPREAD * counts[d][1]:
            fail(f"Ω per-op depth {d} counts {c3[d]} not within "
                 f"{VALID_SPREAD:.1%} of the default path's {counts[d]}")
    say(f"  Ω per-op path to depth 3: counts {c3}; launches {l3}; wall "
        f"{rep3['wall_seconds']:.1f} s")

    ce.reset_launch_counts()
    rep4 = run_cli(omega + ["--batch-size", "4096"], dirs[2])
    out["launches"]["batch_4096"] = l4 = dict(ce.LAUNCHES)
    c4 = counts_of(rep4)
    if l4["structured"] <= 0:
        fail(f"the Ω run at --batch-size 4096 launched {l4}")
    if {d: u for d, (u, _) in c4.items()} != \
            {d: u for d, (u, _) in counts.items()}:
        fail(f"Ω --batch-size 4096 uniques {c4} != the default batch's "
             f"{counts}")
    for d, (_, v) in c4.items():
        if abs(v - counts[d][1]) > VALID_SPREAD * counts[d][1]:
            fail(f"Ω depth {d}: --batch-size 4096 valid {v} vs "
                 f"{counts[d][1]}")
    say(f"  Ω --batch-size 4096 to depth 4: counts {c4}; launches {l4}; "
        f"wall {rep4['wall_seconds']:.1f} s")

    for k in ce.KERNELS:
        if not any(n[k] for n in out["launches"].values()):
            fail(f"the Ω build's {k} kernel was never launched: "
                 f"{out['launches']}")
    t0 = time.time()
    rc, text = captured(lambda: cli([
        "--problem", "force_free", "--omega", str(OMEGA), "--device", "cuda",
        "--db-path", os.path.join(dirs[0], "run.db"), "--print-run-id",
        rep["run_id"], "--verify-pde", "--verify-scope", "valid",
        "--verify-limit", str(AUDIT_LIMIT), "--no-report-families"]))
    if rc != 0:
        fail(f"Ω --print-run-id returned {rc}")
    rcounts, rfound = report_of(text)
    if rcounts != counts or rfound != found:
        fail(f"Ω --print-run-id report {rcounts} {sorted(rfound)} != the "
             f"run's {counts} {sorted(found)}")
    m = re.search(r"verify-pde \[valid\]: (\d+) confirmed, (\d+) refuted, "
                  r"(\d+) skipped", text)
    if not m or int(m.group(2)) or int(m.group(1)) + int(m.group(3)) != \
            AUDIT_LIMIT:
        fail(f"Ω verify-pde: {m and m.group(0)}")
    out["verify_pde"] = m.group(0)
    say(f"  --print-run-id {rep['run_id']} --omega {OMEGA}: report equals "
        f"the run's; {m.group(0)} (the rotating residual); "
        f"{time.time() - t0:.1f} s")
    return out


def phase_tape(card):
    """Phase 19: the tape engine and the library entry point on the card.
    ``DiscoveryEngine(force_free, SearchConfig(engine="tape"),
    device="cuda")`` to depth 3 against the JAX tape engine's CPU counts
    and key digests, its cache rows on the card; then
    ``make_search_kernel`` on the card for force_free's seven knowns and
    ``rho*z`` (the library smoke): each known's relative residual under
    1e-6, ``rho*z``'s about 0.78, the verdicts equal to the CPU twin's and
    the jets within 3e-5 of them after scaling by max(|jet|, 1)."""
    import hashlib

    import numpy as np
    import torch

    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.ops.interpreter import batched_evaluator
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel import make_search_kernel
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    from pde_engine_tpu_torch.utils.config import SearchConfig
    t0 = time.time()
    eng = DiscoveryEngine(load_problem("force_free"), SearchConfig(
        max_depth=3, engine="tape"), device="cuda")
    ce.reset_launch_counts()
    eng.run(3)
    launches = dict(ce.LAUNCHES)
    counts = {s.depth: (s.candidates, s.unique, s.valid) for s in eng.stats}
    digests = {d: hashlib.sha256("\n".join(sorted(
        r.signature for r in eng.rows if r.depth == d)).encode()
        ).hexdigest()[:16] for d in counts}
    for d, want in TAPE_JAX.items():
        got = counts[d]
        tol = 0 if d <= 2 else 0.002
        if any(abs(g - w) > tol * w for g, w in zip(got, want)):
            fail(f"tape depth {d} counts {got} against the JAX tape "
                 f"engine's {want} (tolerance {tol:.1%})")
    same_keys = digests == TAPE_JAX_DIGEST
    if not same_keys:
        say(f"  tape key digests {digests} differ from the JAX tape "
            f"engine's {TAPE_JAX_DIGEST}: this host's NumPy rounds "
            "differently (counts within 0.2%)")
    if eng.cache.screen.device.type != "cuda" or \
            eng.cache.n != sum(u for _, u, _ in counts.values()):
        fail(f"tape cache: {eng.cache.n} rows on {eng.cache.screen.device}")
    found = {r.paper_solution_name for r in eng.valid_rows
             if r.paper_solution_name}
    if found != set(TAPE_KNOWNS):
        fail(f"tape knowns {sorted(found)} != {sorted(TAPE_KNOWNS)}")
    for st in eng.stats:
        say(f"    depth {st.depth}: {st.candidates} candidates, "
            f"{st.unique} unique, {st.valid} valid | wall "
            f"{st.seconds:.3f} s enum {st.t_enum:.3f} ingest "
            f"{st.t_ingest:.3f} gray {st.t_gray:.3f}; the float64 oracle "
            f"and the rest "
            f"{st.seconds - st.t_enum - st.t_ingest - st.t_gray:.3f} s | "
            f"{st.candidates / max(st.seconds, 1e-9):,.0f} candidates/s "
            f"on {card}")
    say(f"  tape engine to depth 3: counts {counts} (the JAX tape engine "
        f"on the CPU: {TAPE_JAX}); key sets "
        + ("equal to the JAX tape engine's (digests)" if same_keys
           else "differ") + f"; knowns {sorted(found)}; {eng.cache.n:,} "
        f"cache rows on {eng.cache.screen.device}; screen kernel launches "
        f"{launches}; {time.time() - t0:.1f} s")
    stats = [{k: getattr(st, k) for k in ("depth", "candidates", "unique",
                                          "valid", "seconds", "t_enum",
                                          "t_ingest", "t_gray")}
             for st in eng.stats]

    p = load_problem("force_free")
    exprs = list(p.known_solutions) + ["rho*z"]
    tapes = [p.parse(x) for x in exprs]
    args_cpu = (torch.as_tensor(np.stack([t.padded(32) for t in tapes])),
                torch.as_tensor(np.array([len(t) for t in tapes], np.int32)),
                torch.as_tensor(p.consts.as_array(np.float32)),
                torch.as_tensor(p.screen_points, dtype=torch.float32),
                torch.as_tensor(p.fingerprint_points, dtype=torch.float32))
    args_gpu = tuple(a.cuda() for a in args_cpu)
    kernel = make_search_kernel(p.residual_order, 32, p.get_residual_key(),
                                p.screen_rtol, len(p.screen_points),
                                len(p.fingerprint_points))
    t1 = time.time()
    sr = kernel(*args_gpu)
    rel = sr.rel_max.cpu().numpy()
    t_kernel = time.time() - t1
    if sr.rel_max.device.type != "cuda":
        fail(f"make_search_kernel ran on {sr.rel_max.device}")
    ref = kernel(*args_cpu)
    for f in ("screen_ok", "nonfinite", "is_const", "fp_finite", "fp_a",
              "fp_b"):
        if not torch.equal(getattr(sr, f).cpu(), getattr(ref, f)):
            fail(f"make_search_kernel {f}: card {getattr(sr, f).tolist()} "
                 f"!= CPU {getattr(ref, f).tolist()}")
    if not (rel[:7] < 1e-6).all() or not 0.7 < rel[7] < 0.9:
        fail(f"library smoke relative residuals {rel.tolist()}")
    run = batched_evaluator(p.residual_order, 32)
    jg = run(*args_gpu[:4]).cpu().numpy().astype(np.float64)
    jc = run(*args_cpu[:4]).numpy().astype(np.float64)
    scale = np.maximum(np.abs(jc), 1.0)
    jet_err = float(np.max(np.abs(jg / scale - jc / scale)))
    if not jet_err <= 3e-5:
        fail(f"batched_evaluator on the card vs the CPU: {jet_err}")
    say(f"  make_search_kernel on {torch.cuda.get_device_name(0)}: relative "
        f"residuals of the 7 knowns {', '.join(f'{x:.2e}' for x in rel[:7])}"
        f"; rho*z {rel[7]:.4f}; verdicts equal to the CPU twin's; "
        f"batched_evaluator jets within {jet_err:.2e} of the CPU's "
        f"(scaled; bound 3e-5); {t_kernel:.2f} s first call")
    return {"counts": counts, "same_keys": same_keys, "stages": stats,
            "launches": launches,
            "library_smoke": {"rel": rel.tolist(), "jet_err": jet_err}}


class Watcher:
    """While a CLI run goes on, one line on stderr every ``WATCH_S``
    seconds: the run's ``--watch-run`` status line (generated
    candidates, rows, valid rows), the ingest sections so far, the
    process's peak RSS and the device memory allocated."""

    def __init__(self, db: str):
        import threading
        self.db = db
        self.t0 = time.time()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)

    def _loop(self):
        import resource
        import sqlite3

        import torch

        from pde_engine_tpu_torch.utils import spans
        from pde_engine_tpu_torch.utils.monitor import format_status
        while not self.stop.wait(WATCH_S):
            status = None
            try:
                con = sqlite3.connect(self.db, timeout=5)
                row = con.execute("SELECT run_id FROM run_metadata"
                                  ).fetchone()
                con.close()
                if row:
                    status = format_status(self.db, row[0])
            except sqlite3.Error as e:
                status = f"(status unreadable: {e})"
            sec = {k[len(spans.SECTION):]: v
                   for k, v in spans.pending().items()
                   if k.startswith(spans.SECTION)}
            print(f"  [watch +{time.time() - self.t0:.0f} s] {status} | "
                  "ingest sections so far: " + " ".join(
                      f"{k} {v:.1f}" for k, v in sec.items())
                  + " | peak RSS "
                  f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f}"
                  " GiB | device "
                  f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB",
                  file=sys.stderr, flush=True)


def phase_depth5(tmp, card, audit: bool):
    """Phases 14 (``--no-audit-rejects``) and 15 (reject rows audited):
    ``--problem force_free --max-depth 5`` through ``cli.main``, with a
    progress line every WATCH_S seconds: depths 1-2 exact, depths 3-5
    within 1% of the TPU run, 7/7 knowns; every depth's stage and ingest
    sections printed.  Returns the run's summary."""
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    d = os.path.join(tmp, "p15" if audit else "p14")
    os.makedirs(d)
    extra = [] if audit else ["--no-audit-rejects"]
    with Watcher(os.path.join(d, "run.db")), DepthLaunches() as by_depth:
        ce.reset_launch_counts()
        rep = run_cli(extra, d, depth=5)
        launches = dict(ce.LAUNCHES)
    counts = counts_of(rep)
    stage_lines(rep, card)
    found = sorted(rep["paper_solutions_found"])
    for dd, want in EXACT.items():
        if counts.get(dd) != want:
            fail(f"depth {dd} counts {counts.get(dd)} != {want}")
    for dd, (u_ref, v_ref) in TPU_D5.items():
        u, v = counts[dd]
        if abs(u - u_ref) > 0.01 * u_ref or abs(v - v_ref) > 0.01 * v_ref:
            fail(f"depth {dd} counts {(u, v)} not within 1% of the TPU "
                 f"run's {(u_ref, v_ref)}")
    if len(found) != 7:
        fail(f"{len(found)}/7 known solutions found: {found}")
    st5 = next(st for st in rep["stats"] if st["depth"] == 5)
    say(f"  7/7 knowns; counts {counts}, within 1% of the TPU run's "
        f"{TPU_D5} at depths 3-5; depth 5: {st5['candidates']:,} "
        f"candidates (TPU 59,171,371); launches {launches}, at depth 5 "
        f"{by_depth.by_depth[5]}; wall {rep['wall_seconds']:.1f} s")
    out = {"audit": audit, "counts": counts, "launches": launches,
           "launches_by_depth": by_depth.by_depth,
           "wall_s": rep["wall_seconds"], "knowns": found,
           "stats": rep["stats"]}
    if not audit:
        say("  the whole bench (seed depth 4, the depth-5 stream) against "
            "this run's depth 5:")
        out["bench"] = run_bench(tmp, "p14", 4, st5, by_depth.by_depth[5],
                                 1200)
    return out


def phase_laplace(tmp, card):
    """Phase 16: laplace to depth 5 three ways (the default batch,
    ``--batch-size 4096``, the per-op path); every key whose verdict
    differs between the default run and another is classed: the kept
    expression differs (dispatch order), or the same expression got
    another screen verdict (float32 rounding), with the float64
    relative residual of each expression's SymPy form."""
    runs = {}
    for tag, extra in (("default", []), ("batch_4096",
                                         ["--batch-size", "4096"]),
                       ("per_op", None)):
        d = os.path.join(tmp, f"p16_{tag}")
        os.makedirs(d)
        if extra is None:
            rep, _ = api_run(d, 5, problem="laplace", use_segmented=False)
        else:
            rep = run_cli(extra + ["--no-report-families"], d,
                          problem="laplace", depth=5)
        runs[tag] = (os.path.join(d, "run.db"), rep)
        say(f"  {tag}: counts {counts_of(rep)}, TPU "
            f"{FAMILIES['laplace'][1]}; dispatches {rep['dispatches']}; "
            f"wall {rep['wall_seconds']:.1f} s")
        stage_lines(rep, card)
    for tag in ("batch_4096", "per_op"):
        keys, flips = verdict_diff(*runs["default"], *runs[tag],
                                   strict=False)
        same = [f for f in flips if f[2][0] == f[3][0]]
        other = [f for f in flips if f[2][0] != f[3][0]]
        say(f"  default against {tag}, per depth [in both, only in "
            f"default, only in {tag}, kept with another expression]: "
            f"{keys}; verdict differs for {len(flips)} keys: "
            f"{len(other)} keep another expression (dispatch "
            f"order), {len(same)} the same expression (screen rounding); "
            f"valid only in default {sum(f[2][1] for f in flips)}, only "
            f"in {tag} {sum(f[3][1] for f in flips)}")
        for d, k, ra, rb in same[:30] + other[:10]:
            for side, r in (("default", ra), (tag, rb)):
                say(f"    depth {d} key {k}, {side}: {r[0]!r} valid={r[1]}"
                    f" ({r[2]}; f64 relmax of its SymPy form "
                    f"{f64_relmax(r[0], 'laplace')!r})")


class MainThreadSampler:
    """Samples the main thread's stack every ``interval`` seconds from a
    thread of its own while active: per function (file:name), the
    samples whose stack holds it.  cProfile on Python 3.12 records every
    thread and attributes callers across them, so it cannot say where
    the main thread's time goes; this can, at no cost to that thread
    beyond the interpreter lock's hand-overs."""

    def __init__(self, interval: float = 0.002):
        import collections
        import threading
        self.interval = interval
        self.main = threading.main_thread().ident
        self.counts = collections.Counter()
        self.samples = 0
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=10)

    def _loop(self):
        while not self.stop.wait(self.interval):
            frame = sys._current_frames().get(self.main)
            seen = set()
            while frame is not None:
                code = frame.f_code
                seen.add(f"{os.path.basename(code.co_filename)}:"
                         f"{code.co_name}")
                frame = frame.f_back
            self.counts.update(seen)
            self.samples += 1

    def share(self, name: str) -> float:
        return self.counts[name] / max(self.samples, 1)


def phase_host(tmp, card, c4):
    """Phase 17: the host questions.  (a) Two more fresh force_free
    depth-4 CLI runs, with their stages and ingest sections (phase 4 is
    the first sample of the spread); the second with the main thread's
    stack sampled through the depth stages (``MainThreadSampler``): the
    share of that time in each of the engine's and the runtime's steps,
    those outside the timed sections included.  (b) A depth-3 CLI run
    resumed to depth 4 from four copies, in turns with its DB's
    secondary indices left to the resume (which drops them before the
    resumed depth and builds them at completion) and dropped
    beforehand (the copy's indices removed and ``RunDB.ensure_indices``
    a no-op for the whole resumed run), each with its stage and ingest
    sections."""
    import sqlite3

    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    from pde_engine_tpu_torch.utils.db import RunDB
    engine_run = DiscoveryEngine.run

    def around_run(cm):
        """Run ``DiscoveryEngine.run`` inside the context ``cm``."""
        def run(self, *a, **kw):
            with cm:
                return engine_run(self, *a, **kw)
        return run

    sampler = MainThreadSampler()
    for i in (1, 2):
        d = os.path.join(tmp, f"p17_fresh{i}")
        os.makedirs(d)
        if i == 2:
            DiscoveryEngine.run = around_run(sampler)
        try:
            rep = run_cli([], d)
        finally:
            DiscoveryEngine.run = engine_run
        if counts_of(rep) != c4:
            fail(f"fresh depth-4 run {i}: counts {counts_of(rep)} != {c4}")
        say(f"  fresh run {i + 1} of force_free --max-depth 4 (phase 4 "
            f"was the first): wall {rep['wall_seconds']:.1f} s")
        stage_lines(rep, card)
    stages = sum(st["seconds"] for st in rep["stats"])
    steps = ("_run_depth_segmented", "drain_tail", "drain_head",
             "_ingest_vec", "_gray_maybe_submit", "_emit_gray_part",
             "_finalize_pass", "_match_known", "_add_row", "on_row",
             "add_row", "expr_str", "_flush_gray", "on_batch", "on_depth",
             "route_segmented", "launch", "timed", "_unpack_start",
             "_unpack_finish")
    shares = sorted(((k, sampler.share(k)) for k in sampler.counts
                     if k.split(":")[1] in steps), key=lambda kv: -kv[1])
    say(f"  main thread of fresh run 3, {sampler.samples} stack samples "
        f"over its depth stages ({stages:.3f} s): share of the samples "
        "(seconds at that share) in " + "; ".join(
            f"{k} {v:.3f} ({v * stages:.3f} s)" for k, v in shares))

    d3 = os.path.join(tmp, "p17_d3")
    os.makedirs(d3)
    rep3 = run_cli(["--max-depth", "3", "--no-report-families"], d3)
    table = "expressions_" + rep3["run_id"].replace("-", "_")
    orig = RunDB.ensure_indices
    for i, drop in enumerate((False, True, True, False)):
        dc = os.path.join(tmp, f"p17_resume{i}")
        shutil.copytree(d3, dc)
        if drop:
            con = sqlite3.connect(os.path.join(dc, "run.db"))
            for name, in con.execute(
                    "SELECT name FROM sqlite_master WHERE type='index' "
                    "AND tbl_name=? AND name LIKE 'idx_%'",
                    (table,)).fetchall():
                con.execute(f"DROP INDEX {name}")
            con.commit()
            con.close()
            RunDB.ensure_indices = lambda self: None
        try:
            rep = run_cli(["--resume-run", rep3["run_id"],
                           "--no-report-families"], dc)
        finally:
            RunDB.ensure_indices = orig
        if counts_of(rep) != c4:
            fail(f"resume {i}: counts {counts_of(rep)} != {c4}")
        say(f"  resumed 3->4 with the secondary indices "
            f"{'dropped beforehand' if drop else 'left to the resume'}: wall "
            f"{rep['wall_seconds']:.1f} s")
        stage_lines(rep, card)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(args, d, tag, timeout=600):
    """``python -m pde_engine_tpu_torch <args> --multihost`` as two
    processes sharing the card (``PDE_ENGINE_NUM_PROCESSES=2``,
    ``PDE_ENGINE_PROCESS_ID``, ``PDE_ENGINE_COORDINATOR`` on a free local
    port), each in a directory of its own.  If either fails or the pair
    outlives ``timeout``, both are killed and the phase fails.  Returns
    each rank's output."""
    here = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    procs, logs = [], []
    for r in (0, 1):
        cwd = os.path.join(d, f"rank{r}")
        os.makedirs(cwd, exist_ok=True)
        logs.append(os.path.join(d, f"{tag}_rank{r}.log"))
        env = dict(os.environ, PDE_ENGINE_NUM_PROCESSES="2",
                   PDE_ENGINE_PROCESS_ID=str(r),
                   PDE_ENGINE_COORDINATOR=f"127.0.0.1:{port}",
                   PYTHONPATH=here)
        with open(logs[-1], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pde_engine_tpu_torch", *args,
                 "--multihost"], cwd=cwd, env=env, stdout=fh,
                stderr=subprocess.STDOUT))
    t0 = time.time()
    try:
        while any(p.poll() is None for p in procs):
            bad = [p.returncode for p in procs
                   if p.poll() is not None and p.returncode != 0]
            if bad or time.time() - t0 > timeout:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for p, log in zip(procs, logs):
        with open(log) as fh:
            texts.append(fh.read())
    if any(p.returncode != 0 for p in procs):
        for r, t in enumerate(texts):
            say(f"  rank {r} output (last lines):\n    "
                + "\n    ".join(t.strip().splitlines()[-15:]))
        fail(f"{tag}: ranks exited {[p.returncode for p in procs]} after "
             f"{time.time() - t0:.1f} s")
    return texts


def rank_record(text):
    """(backend, [(depth, candidates, uniques)], the rank's closing
    record) from a ``--multihost`` run's output."""
    import re
    first = text.splitlines()[0] if text else ""
    m = re.match(r"distributed: rank (\d+) of 2, backend (\w+)", first)
    if m is None:
        fail(f"the run's first line names no backend: {first!r}")
    depths = [tuple(int(x) for x in g) for g in re.findall(
        r"^  depth (\d+): (\d+) candidates, (\d+) unique", text, re.M)]
    rec = re.search(r"^process (\d) of 2: (\d+) uniques, dedup map (\d+) "
                    r"keys, (\d+) shard launches, kernel launches (\{.*\})$",
                    text, re.M)
    if rec is None:
        fail("a rank printed no closing record")
    return m.group(2), depths, {
        "rank": int(rec.group(1)), "uniques": int(rec.group(2)),
        "map_keys": int(rec.group(3)), "shard_launches": int(rec.group(4)),
        "launches": json.loads(rec.group(5))}


def mesh_report(rep, tag, card, ref_db, ref_rep, db, launches, depth=4):
    """The checks every one-process mesh run shares: the knowns (7/7 at
    depth 4), the per-op run's rows of its depths row for row, universal
    launches only, one for each non-empty shard the engine counted."""
    if depth == 4 and len(rep["paper_solutions_found"]) != 7:
        fail(f"{tag}: knowns {rep['paper_solutions_found']}")
    n = same_rows(ref_db, ref_rep, db, rep, f"WHERE depth <= {depth}")
    m = rep["mesh"]
    if (launches["universal"] != m["shard_launches"]
            or launches["universal"] <= 0
            or any(launches[k] for k in ("segmented", "structured",
                                         "tiled"))):
        fail(f"{tag}: launches {launches}, the engine counted "
             f"{m['shard_launches']} shard launches")
    layout = "uid-range-sharded" if m["shard_cache"] else "replicated"
    say(f"  {tag}: mesh {m['devices']} ({layout} cache), backend "
        f"{m['backend'] or 'none (one process)'}; depth {depth}; "
        f"{len(rep['paper_solutions_found'])} knowns; rows equal the "
        f"per-op run's row for row ({n:,}); "
        f"{rep['dispatches']['universal']} op batches, universal launches "
        f"{launches['universal']} (one per non-empty shard); wall "
        f"{rep['wall_seconds']:.1f} s")
    stage_lines(rep, card)
    return n


def phase_mesh(tmp, card, per_op):
    """Phase 20: the mesh paths on the card (module docstring).
    ``per_op`` is phase 6's (db, report) when it ran.  Returns the
    phase's record and its launch counts by run."""
    from pde_engine_tpu_torch.dryrun import dryrun_multichip
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.parallel.mesh import CandidateMesh
    from pde_engine_tpu_torch.runtime import DiscoveryRun
    from pde_engine_tpu_torch.utils.config import SearchConfig
    out, launches = {}, {}
    dirs = {k: os.path.join(tmp, f"p20{k}") for k in
            ("ref", "a", "b", "c", "c2", "d")}
    for d in dirs.values():
        os.makedirs(d)
    if per_op is None:
        rep_ref, _ = api_run(dirs["ref"], 4, use_segmented=False)
        per_op = (os.path.join(dirs["ref"], "run.db"), rep_ref)
    ref_db, ref_rep = per_op

    # (a) --devices 1 through the CLI
    with DepthLaunches("_run_depth_per_op") as by_depth:
        ce.reset_launch_counts()
        rep_a = run_cli(["--devices", "1", "--no-report-families"],
                        dirs["a"])
        launches["mesh_cli"] = dict(ce.LAUNCHES)
    db_a = os.path.join(dirs["a"], "run.db")
    mesh_report(rep_a, "(a) --devices 1", card, ref_db, ref_rep, db_a,
                launches["mesh_cli"])
    st4 = next(st for st in rep_a["stats"] if st["depth"] == 4)
    out["cli_devices_1"] = {"counts": counts_of(rep_a),
                            "wall_s": rep_a["wall_seconds"],
                            "launches": launches["mesh_cli"]}

    # (b), (c): two shards on one card, through the library, to depth 3
    # (the default run's time; the depth-4 shard-cache run follows)
    mesh2 = CandidateMesh(["cuda:0", "cuda:0"])
    for k, tag, cfg in (("b", "mesh_replicated", {}),
                        ("c", "mesh_shard_cache", {"shard_cache": True})):
        ce.reset_launch_counts()
        rep, _ = api_run(dirs[k], MESH_LIB_DEPTH, mesh=mesh2, **cfg)
        launches[tag] = dict(ce.LAUNCHES)
        mesh_report(rep, f"({k}) {tag}", card, db_a, rep_a,
                    os.path.join(dirs[k], "run.db"), launches[tag],
                    MESH_LIB_DEPTH)
        out[tag] = {"wall_s": rep["wall_seconds"], "depth": MESH_LIB_DEPTH,
                    "launches": launches[tag],
                    "stages": rep["stats"][1:]}
    # (c) to depth 4 with a window of DEPTH3_ROWS // 2 + 1 rows a shard:
    # one shard could not hold the depth-4 parents, the mesh can
    window = DEPTH3_ROWS // 2 + 1
    ce.reset_launch_counts()
    run = DiscoveryRun("force_free", config=SearchConfig(
        max_depth=4, shard_cache=True, max_cache_rows=window),
        db_path=os.path.join(dirs["c2"], "run.db"), device="cuda",
        verbose=False, report_families=False, mesh=mesh2)
    rep_c2, text = captured(lambda: run.run(4))
    launches["mesh_window"] = dict(ce.LAUNCHES)
    n_cache = run.engine.cache.n
    run.close()
    if "truncated" in text or n_cache < DEPTH3_ROWS:
        fail(f"(c) window of {window} rows a shard: cache {n_cache} rows "
             f"of {DEPTH3_ROWS} parents; truncation {'truncated' in text}")
    mesh_report(rep_c2, f"(c) mesh_window, {window} rows a shard", card,
                db_a, rep_a, os.path.join(dirs["c2"], "run.db"),
                launches["mesh_window"])
    say(f"  (c) no truncation: cache {n_cache:,} rows, the {DEPTH3_ROWS:,} "
        "uniques through depth 3 over two shards of "
        f"{window:,} rows")
    out["mesh_window"] = {"wall_s": rep_c2["wall_seconds"],
                          "window_per_shard": window, "cache_rows": n_cache,
                          "launches": launches["mesh_window"],
                          "stage_d4": next(st for st in rep_c2["stats"]
                                           if st["depth"] == 4)}

    # (d) two processes on the card over gloo, sharded registry
    shared = os.path.join(dirs["d"], "shared")
    os.makedirs(shared)
    common = ["--problem", "force_free", "--device", "cuda",
              "--shard-registry", "--no-report-families", "--db-path",
              os.path.join(shared, "run.db")]
    t0 = time.time()
    first = run_pair(common + ["--max-depth", str(MULTIHOST_DEPTH - 1)],
                     dirs["d"], f"d{MULTIHOST_DEPTH - 1}")
    import re
    run_id = re.search(r"^Run (\S+):", first[0], re.M).group(1)
    second = run_pair(common + ["--max-depth", str(MULTIHOST_DEPTH),
                                "--resume-run", run_id], dirs["d"], "resume")
    wall_d = time.time() - t0
    recs = []
    for r in (0, 1):
        b1, dep1, rec1 = rank_record(first[r])
        b2, dep2, rec2 = rank_record(second[r])
        if {b1, b2} != {"gloo"}:
            fail(f"rank {r}: backends {b1}, {b2}; processes that share a "
                 "card take gloo")
        recs.append((dep1 + dep2, rec1, rec2))
        launches[f"multihost_rank{r}"] = {
            k: rec1["launches"][k] + rec2["launches"][k]
            for k in rec1["launches"]}
    if recs[0][0] != recs[1][0]:
        fail(f"the ranks' depths differ: {recs[0][0]} against {recs[1][0]}")
    uniques = recs[0][2]["uniques"]
    keys = [recs[r][2]["map_keys"] for r in (0, 1)]
    if sum(keys) != uniques or min(keys) == 0:
        fail(f"dedup maps {keys} do not partition the {uniques} uniques")
    for r in (0, 1):
        if os.listdir(os.path.join(dirs["d"], f"rank{r}")):
            fail(f"rank {r} wrote into its directory: "
                 f"{os.listdir(os.path.join(dirs['d'], f'rank{r}'))}")
        if not os.path.exists(os.path.join(
                shared, f"run.db.registry.keys.{r}.npz")):
            fail(f"no key shard file of rank {r}")
        if launches[f"multihost_rank{r}"]["universal"] <= 0:
            fail(f"rank {r} launched no universal kernel")
    reports = sorted(f for f in os.listdir(shared)
                     if f.startswith("reproduction_") and f.endswith(".json"))
    if len(reports) != 2:
        fail(f"{len(reports)} report sets for the pair's 2 runs: {reports}")
    with open(os.path.join(shared, reports[-1])) as fh:
        rep_d = json.load(fh)
    n_d = same_rows(db_a, rep_a, os.path.join(shared, "run.db"), rep_d,
                    f"WHERE depth <= {MULTIHOST_DEPTH}")
    ex = rep_d["mesh"]["exchange"]
    say(f"  (d) 2 processes on one card, gloo, sharded registry: depth "
        f"{MULTIHOST_DEPTH - 1} then resumed to {MULTIHOST_DEPTH} in "
        f"{wall_d:.1f} s; both ranks "
        f"{recs[0][0]}; dedup maps {keys} keys (sum {uniques:,}, the "
        f"uniques); the writer's rows equal (a)'s of depths 1-"
        f"{MULTIHOST_DEPTH} row for row ({n_d:,}), "
        f"{len(rep_d['paper_solutions_found'])} knowns; "
        f"rank 1 wrote nothing; key shards of ranks 0 and 1; universal "
        f"launches {launches['multihost_rank0']['universal']} and "
        f"{launches['multihost_rank1']['universal']}; the writer's "
        f"resumed exchange {ex['calls']} all-gathers, "
        f"{ex['seconds']:.3f} s, {ex['bytes'] / 1e6:.1f} MB")
    stage_lines(rep_d, card)
    out["multihost"] = {"wall_s": wall_d, "depths": recs[0][0],
                        "map_keys": keys, "exchange_resumed_rank0": ex,
                        "launches": {r: launches[f"multihost_rank{r}"]
                                     for r in (0, 1)},
                        "stage": next(st for st in rep_d["stats"]
                                      if st["depth"] == MULTIHOST_DEPTH)}

    # (e) the dry run over two shards of the card, and the mesh bench
    ce.reset_launch_counts()
    dry, text = captured(lambda: dryrun_multichip(2, "cuda"))
    launches["dryrun"] = dict(ce.LAUNCHES)
    say("  (e) " + "\n      ".join(text.strip().splitlines()))
    env = dict(os.environ, HOME=os.path.join(tmp, "p20_home"))
    env.pop("PDE_BENCH_BATCH", None)
    r = subprocess.run([sys.executable, "-m", "pde_engine_tpu_torch.bench",
                        "--devices", "1"], capture_output=True, text=True,
                       env=env, timeout=900,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = r.stdout.splitlines()
    if r.returncode != 0 or len(lines) != 1:
        fail(f"bench --devices 1 returned {r.returncode}, {len(lines)} "
             f"lines: {r.stdout[-1000:]} {r.stderr[-2000:]}")
    bench = json.loads(lines[0])
    det = bench["detail"]
    per_rep = det["launches_per_rep"]
    want = by_depth.by_depth[4]
    if (bench["metric"] != "mesh_sharded_validations_per_sec"
            or det["candidates_timed"] != st4["candidates"]
            or per_rep != want or det["first_batch_rows_differ"] != 0):
        fail(f"bench --devices 1: {det['candidates_timed']} candidates "
             f"(depth 4: {st4['candidates']}), launches a repetition "
             f"{per_rep} (the mesh engine's depth 4: {want}), first batch "
             f"rows differing {det['first_batch_rows_differ']}")
    launches["mesh_bench"] = det["kernel_launches"]
    say(f"  (e) bench --devices 1: {bench['value']:,.0f} "
        f"{bench['unit']} (median of {det['reps']}: {det['seconds']}); "
        f"{det['candidates_timed']:,} candidates (depth 4's) in "
        f"{det['batches']} batches, launches a repetition {per_rep} (the "
        f"mesh engine's depth 4); first batch bit-equal to its plain twin; "
        f"{det['card']}")
    out["dryrun"] = dry
    out["bench"] = bench
    return out, launches


def tree_digest(d):
    """{path under ``d``: sha256} of every file under ``d``."""
    import hashlib
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def funnel_rows(db):
    """The rows of the run in ``db`` (one run a DB) that reached the
    symbolic stage, the screen's and the float64 recheck's rejects left
    out, as sorted lines ``signature|is_valid|validation_reason|
    validator_method|heavy_is_valid|heavy_reason``."""
    import sqlite3
    con = sqlite3.connect(db)
    (table,) = [r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE name LIKE 'expressions_%'")]
    rows = con.execute(
        "SELECT signature, is_valid, validation_reason, validator_method, "
        f"heavy_is_valid, heavy_reason FROM {table} WHERE validator_method "
        "NOT IN ('screen', 'screen+f64')").fetchall()
    con.close()
    return sorted("|".join(str(x) for x in r) for r in rows)


def funnel_digest(lines) -> str:
    """The first 16 hex digits of the sha256 of ``funnel_rows``, joined
    by newlines."""
    import hashlib
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def check_config(tag, rep, ref, knowns):
    """A configuration's run against the JAX package's CPU run: per depth
    (candidates, uniques, valid), depths 1-2 exact and deeper within 1%,
    and the same knowns.  Returns {depth: (candidates, uniques, valid)}."""
    got = {st["depth"]: (st["candidates"], st["unique"], st["valid"])
           for st in rep["stats"]}
    for d, want in ref.items():
        have = got.get(d, (0, 0, 0))
        tol = 0 if d <= 2 else 0.01
        if any(abs(h - w) > tol * w for h, w in zip(have, want)):
            fail(f"{tag} depth {d} (candidates, uniques, valid) {have} "
                 f"against the JAX package's {want} (tolerance {tol:.0%})")
    found = set(rep["paper_solutions_found"])
    if found != set(knowns):
        fail(f"{tag} knowns {sorted(found)} != the JAX package's "
             f"{sorted(knowns)}")
    return got


def config_resumes(tmp, tag, flags, depth, fresh, refuse, launches):
    """A force_free run under ``flags`` to ``depth - 1``, resumed to
    ``depth`` without them: from its registry sidecar, and in a copy
    without the sidecar from its DB rows (phase 11's way).  Each must
    equal the fresh run ``fresh`` (its directory and report) row for row.
    First a resume that asks for ``refuse``, a flag the run recorded on,
    must exit 2 with one line and leave every file of the run as it was.
    Each run's launch counts go into ``launches``."""
    from pde_engine_tpu_torch.cli import main as cli
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    part = os.path.join(tmp, f"p21{tag}_part")
    copy = os.path.join(tmp, f"p21{tag}_db")
    os.makedirs(part)
    ce.reset_launch_counts()
    prep = run_cli(flags + ["--no-report-families"], part, depth=depth - 1)
    launches[f"{tag}_part"] = dict(ce.LAUNCHES)
    before = tree_digest(part)
    ce.reset_launch_counts()
    rc, text = captured(lambda: cli([
        "--problem", "force_free", "--max-depth", str(depth), "--device",
        "cuda", "--db-path", os.path.join(part, "run.db"), "--resume-run",
        prep["run_id"], "--no-report-families", refuse]))
    lines = text.strip().splitlines()
    if rc != 2 or len(lines) != 1 or not lines[0].startswith("error: ") \
            or any(ce.LAUNCHES.values()) or tree_digest(part) != before:
        fail(f"{tag}: the resume asking for {refuse} returned {rc}, said "
             f"{lines[:3]}, launched {dict(ce.LAUNCHES)}, and "
             f"{'left' if tree_digest(part) == before else 'changed'} the "
             "run's files")
    shutil.copytree(part, copy)
    drop_sidecar(copy)
    out = {"refused": lines[0]}
    for how, d in (("sidecar", part), ("db_rebuild", copy)):
        log = []
        ce.reset_launch_counts()
        rrep = run_cli(["--resume-run", prep["run_id"],
                        "--no-report-families"], d, depth=depth, log=log)
        launches[f"{tag}_resume_{how}"] = dict(ce.LAUNCHES)
        if ("from its DB rows" in log[0]) != (how == "db_rebuild"):
            fail(f"{tag}: the {how} resume did not take its path")
        if counts_of(rrep) != counts_of(fresh[1]):
            fail(f"{tag}: resumed ({how}) counts {counts_of(rrep)} != the "
                 f"fresh run's {counts_of(fresh[1])}")
        n = same_rows(os.path.join(fresh[0], "run.db"), fresh[1],
                      os.path.join(d, "run.db"), rrep)
        out[how] = {"rows": n, "wall_s": rrep["wall_seconds"]}
    say(f"  {tag}: {' '.join(flags)} to depth {depth - 1}, resumed to "
        f"depth {depth} without the flags: sidecar and DB-rebuild resumes "
        f"equal the fresh run row for row ({out['sidecar']['rows']:,} rows; "
        f"walls {out['sidecar']['wall_s']:.1f} / "
        f"{out['db_rebuild']['wall_s']:.1f} s); {refuse} refused with exit "
        f"2, no file changed: {lines[0]!r}")
    return out


def phase_configs(tmp, card, deep):
    """Phase 21: the JAX CLI's remaining run configurations through the
    port's CLI on the card, each held to the JAX package's CPU run:
    force_free ``--no-special-ops`` to depth 4 (the default batch, the
    per-op path to depth 3, and ``--batch-size 4096`` to depth 4, so
    that all four kernels launch), laplace ``--mode sequential
    --heavy-checks`` to depth 3, and force_free ``--no-prune`` to depth 3
    (depth 4 with ``deep``); each force_free configuration resumed
    without its flag from the sidecar and from the DB rows, row for row
    equal to its fresh run, after a refused resume that asks for a flag
    the run recorded on.  Returns (summary, launch counts by run)."""
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    launches, out = {}, {}
    nso = ["--no-special-ops"]
    d = os.path.join(tmp, "p21nso")
    os.makedirs(d)
    with LaunchTimer(trace=True) as timer:
        ce.reset_launch_counts()
        rep = run_cli(nso + ["--no-report-families"], d)
        launches["nso"] = dict(ce.LAUNCHES)
    got = check_config("--no-special-ops", rep, NSO_JAX, NSO_KNOWNS)
    special = db_rows(os.path.join(d, "run.db"), rep, "COUNT(*)",
                      "WHERE " + " OR ".join(
                          f"expression LIKE '%{op}(%'"
                          for op in SPECIAL_OPS))[0][0]
    if special:
        fail(f"--no-special-ops: {special} rows spell a special op")
    stage_lines(rep, card)
    say(f"  --no-special-ops --max-depth 4: (candidates, uniques, valid) "
        f"{got} (the JAX package on the CPU: {NSO_JAX}); knowns "
        f"{sorted(rep['paper_solutions_found'])}; launches "
        f"{launches['nso']}; kernel device ms (activity trace) "
        + ", ".join(f"{k} {fmt_ms(timer.device_ms(k))}"
                    for k in ("segmented", "tiled"))
        + f"; wall {rep['wall_seconds']:.1f} s")
    out["no_special_ops"] = {
        "counts": got, "wall_s": rep["wall_seconds"],
        "device_ms": {k: timer.device_ms(k) for k in ce.KERNELS
                      if timer.events[k]},
        "resume": config_resumes(tmp, "nso", nso, 4, (d, rep),
                                 "--no-prune", launches)}

    ce.reset_launch_counts()
    rep3, _ = api_run(os.path.join(tmp, "p21nso_per_op"), 3,
                      use_segmented=False, include_special_ops=False)
    launches["nso_per_op_d3"] = l3 = dict(ce.LAUNCHES)
    c3 = {st["depth"]: (st["candidates"], st["unique"], st["valid"])
          for st in rep3["stats"]}
    if l3["universal"] <= 0 or any(l3[k] for k in ("segmented", "structured",
                                                   "tiled")):
        fail(f"the --no-special-ops per-op run launched {l3}: want "
             "universal only")
    for dd in (1, 2, 3):
        if c3[dd][0] != got[dd][0] or any(
                abs(c3[dd][i] - got[dd][i]) > VALID_SPREAD * got[dd][i]
                for i in (1, 2)):
            fail(f"--no-special-ops per-op depth {dd} {c3[dd]} not within "
                 f"{VALID_SPREAD:.1%} of the default path's {got[dd]}")
    say(f"  --no-special-ops, per-op path to depth 3: {c3}; launches {l3}; "
        f"wall {rep3['wall_seconds']:.1f} s")

    d = os.path.join(tmp, "p21nso_4096")
    os.makedirs(d)
    ce.reset_launch_counts()
    rep4 = run_cli(nso + ["--batch-size", "4096", "--no-audit-rejects",
                          "--no-report-families"], d)
    launches["nso_batch_4096"] = l4 = dict(ce.LAUNCHES)
    c4 = counts_of(rep4)
    if l4["structured"] <= 0:
        fail(f"--no-special-ops at --batch-size 4096 launched {l4}")
    for dd, (u, v) in c4.items():
        if u != got[dd][1] or abs(v - got[dd][2]) > VALID_SPREAD * got[dd][2]:
            fail(f"--no-special-ops depth {dd}: --batch-size 4096 {(u, v)} "
                 f"against the default batch's {got[dd][1:]}")
    say(f"  --no-special-ops --batch-size 4096 to depth 4: {c4}; launches "
        f"{l4}; wall {rep4['wall_seconds']:.1f} s")

    d = os.path.join(tmp, "p21seq")
    os.makedirs(d)
    ce.reset_launch_counts()
    rep = run_cli(["--mode", "sequential", "--heavy-checks",
                   "--no-report-families"], d, problem="laplace", depth=3)
    launches["laplace_sequential"] = dict(ce.LAUNCHES)
    got = check_config("laplace --mode sequential --heavy-checks", rep,
                       SEQ_JAX, SEQ_KNOWNS)
    lines = funnel_rows(os.path.join(d, "run.db"))
    digest = funnel_digest(lines)
    errors = sum("symbolic-error" in ln for ln in lines)
    if (len(lines), digest) != SEQ_FUNNEL or errors:
        fail(f"laplace --mode sequential --heavy-checks: {len(lines)} rows "
             f"reached the symbolic stage (digest {digest}, {errors} "
             f"symbolic errors), the JAX package's {SEQ_FUNNEL}; e.g. "
             f"{lines[:3]}")
    say(f"  laplace --mode sequential --heavy-checks --max-depth 3: {got}; "
        f"{len(lines)} rows reached the symbolic stage, their (signature, "
        f"is_valid, reason, method, heavy_is_valid, heavy_reason) digest "
        f"{digest}, the JAX package's; launches "
        f"{launches['laplace_sequential']}; wall {rep['wall_seconds']:.1f} s")
    out["sequential"] = {"counts": got, "funnel_rows": len(lines),
                         "digest": digest, "wall_s": rep["wall_seconds"]}

    np_depth = 4 if deep else 3
    npf = ["--no-prune"]
    d = os.path.join(tmp, "p21np")
    os.makedirs(d)
    with LaunchTimer(trace=True) as timer:
        ce.reset_launch_counts()
        rep = run_cli(npf + ["--no-report-families"], d, depth=np_depth)
        launches["no_prune"] = dict(ce.LAUNCHES)
    got = check_config("--no-prune", rep,
                       {k: v for k, v in NP_JAX.items() if k <= np_depth},
                       NP_KNOWNS[np_depth])
    stage_lines(rep, card)
    say(f"  --no-prune --max-depth {np_depth}: {got} (the JAX package on the "
        f"CPU: {NP_JAX}); knowns {sorted(rep['paper_solutions_found'])}; "
        f"launches {launches['no_prune']}; kernel device ms (activity "
        "trace) " + ", ".join(f"{k} {fmt_ms(timer.device_ms(k))}"
                              for k in ("segmented", "tiled"))
        + f"; wall {rep['wall_seconds']:.1f} s")
    out["no_prune"] = {
        "depth": np_depth, "counts": got, "wall_s": rep["wall_seconds"],
        "stages": [{k: st[k] for k in ("depth", "candidates", "unique",
                                         "valid", "seconds", "t_enum",
                                         "t_device", "t_ingest", "t_gray")}
                   for st in rep["stats"]],
        "device_ms": {k: timer.device_ms(k) for k in ce.KERNELS
                      if timer.events[k]},
        "resume": config_resumes(tmp, "np", npf, np_depth, (d, rep),
                                 "--no-special-ops", launches)}

    total = {k: sum(n[k] for n in launches.values()) for k in ce.KERNELS}
    for k, n in total.items():
        if not n:
            fail(f"kernel {k} was never launched by phase 21: {launches}")
    out["launches"] = launches
    return out, {f"configs_{k}": v for k, v in launches.items()}


# phase 22: screen_ok of the JAX package's __graft_entry__.entry() batch
# (force_free's seven knowns, then rho*z) under jax.jit on the CPU, to
# which tests/test_torch_library.py::test_entry_equals_jax_entry holds
# the port's entry("cpu")
ENTRY_SCREEN_OK_JAX = (True,) * 7 + (False,)
ENTRY_FLAGS = ("screen_ok", "nonfinite", "is_const", "fp_finite", "fp_a",
               "fp_b")
INSTALLED_ROWS = 4096   # phase 22's universal launch from the copy
# the JAX DepthStats fields, each depth's entry of summary()
SUMMARY_DEPTH_FIELDS = ("depth", "candidates", "unique", "valid", "seconds",
                        "t_enum", "t_device", "t_ingest", "t_gray")
# phase 22 (c), in a process of its own: the package copy at argv[1]
# builds force_free's kernels and the native core, and launches universal
# once against its plain twin
_INSTALLED = r"""
import json, os, sys, time
sys.modules["jax"] = None
sys.modules["pde_engine_tpu"] = None
import numpy as np
import torch
import pde_engine_tpu_torch as pkg
from pde_engine_tpu_torch.parallel import cuda_engine as ce
from pde_engine_tpu_torch.parallel.incremental import OP_INDEX
from pde_engine_tpu_torch.parallel.search import snap_fp_jets_np
from pde_engine_tpu_torch.pipeline import cuda_emit_spec
from pde_engine_tpu_torch.utils import cuda_build, native
site, rows = sys.argv[1], int(sys.argv[2])
if not os.path.abspath(pkg.__file__).startswith(site + os.sep):
    sys.exit(f"imported {pkg.__file__}, not the copy under {site}")
p = pkg.load_problem("force_free")
spec = cuda_emit_spec(p, p.screen_rtol)
t0 = time.time()
core = native.load_core()
lib = ce._library(spec)
t_build = time.time() - t0
rng = np.random.default_rng(22)
C = 4 * rows
cs = torch.as_tensor(rng.normal(0.0, 0.5, size=(C, spec.sdim)).astype(
    np.float32)).cuda()
cf = torch.as_tensor(snap_fp_jets_np(rng.uniform(0.3, 1.5, size=(
    C, spec.fdim)).astype(np.float32))).cuda()
ab = torch.as_tensor(rng.integers(0, C, size=(rows, 2), dtype=np.int32)
                     ).cuda()
sp, fp = (torch.as_tensor(np.asarray(x, np.float32)).cuda()
          for x in (p.screen_points, p.fingerprint_points))
args = (ab, OP_INDEX["mul"], sp, fp)
out = ce.universal(spec, cs, cf, *args)
ref = ce.universal_ref(spec, cs, cf, *args)
same = all(bool(((x.view(torch.int32) == y.view(torch.int32))
                 | (torch.isnan(x) & torch.isnan(y))).all())
           if x.is_floating_point() else torch.equal(x, y)
           for x, y in zip(out, ref))
print(json.dumps({"root": cuda_build.build_root(),
                  "core": core and core._name, "screen": lib._name,
                  "launches": ce.LAUNCHES["universal"], "bit_equal": same,
                  "build_s": t_build}))
"""


def phase_surface(tmp, canary_run):
    """Phase 22: (a) the library surface with jax blocked, and
    ``dryrun.entry()`` on the card against the JAX package's screen_ok;
    (b) ``summary()`` of phase 13's engine against its stats and its
    launches; (c) a copy of the package alone, outside any checkout,
    with ``HOME`` and ``XDG_CACHE_HOME`` elsewhere, building force_free's
    kernels and the native core under the user cache directory,
    launching ``universal`` bit-equal to its plain twin, and writing
    nothing inside itself.  Returns what each found."""
    import torch

    import pde_engine_tpu_torch as pkg
    from pde_engine_tpu_torch import dryrun
    from pde_engine_tpu_torch.ops import jets, optable, tape
    from pde_engine_tpu_torch.utils import SearchConfig
    from pde_engine_tpu_torch.utils.config import SearchConfig as config_sc

    # (a)
    t0 = time.time()
    if sys.modules.get("jax") is not None or \
            sys.modules.get("pde_engine_tpu") is not None:
        fail("jax or the JAX package was imported")
    problem = pkg.load_problem("force_free")
    mods = (jets, optable, tape)
    if problem.slug != "force_free" or len(problem.known_solutions) != 7 \
            or SearchConfig is not config_sc or any(
                m.__name__ != f"pde_engine_tpu_torch.ops.{n}"
                for m, n in zip(mods, ("jets", "optable", "tape"))):
        fail(f"library surface: {problem.slug}, {SearchConfig}, {mods}")
    kernel, args = dryrun.entry()
    if any(a.device.type != "cuda" for a in args):
        fail(f"entry() arguments on {[str(a.device) for a in args]}")
    sr = kernel(*args)
    ok = tuple(bool(x) for x in sr.screen_ok.cpu())
    if ok != ENTRY_SCREEN_OK_JAX:
        fail(f"entry() screen_ok {ok}, the JAX package's {ENTRY_SCREEN_OK_JAX}")
    kc, ac = dryrun.entry("cpu")
    ref = kc(*ac)
    for f in ENTRY_FLAGS:
        if not torch.equal(getattr(sr, f).cpu(), getattr(ref, f)):
            fail(f"entry() {f} on the card {getattr(sr, f).tolist()} != "
                 f"the CPU's {getattr(ref, f).tolist()}")
    rel = sr.rel_max.cpu().tolist()
    say(f"  load_problem, utils.SearchConfig, ops.{{jets, optable, tape}} "
        f"resolve with jax blocked; entry() on the card: screen_ok {ok} "
        f"(the JAX package's), verdict flags and fingerprints equal to the "
        f"CPU's, rel_max {', '.join(f'{x:.3e}' for x in rel)}; "
        f"{time.time() - t0:.1f} s")

    # (b)
    summ = canary_run["summary"]
    print("  summary() of phase 13's engine: " + json.dumps(summ),
          flush=True)
    stats, lr = canary_run["stats"], canary_run["launched_rows"]
    want_depths = [{k: st[k] for k in SUMMARY_DEPTH_FIELDS} for st in stats]
    launched = sum(v["candidates"] for v in lr.values())
    if summ["depths"] != want_depths:
        fail(f"summary depths {summ['depths']} != stats {want_depths}")
    for key, want in (
            ("total_candidates", sum(st["candidates"] for st in stats)),
            ("total_unique", sum(st["unique"] for st in stats)),
            ("total_valid", canary_run["valid_rows"]),
            ("candidates_screened", canary_run["oracle_rows"] + launched)):
        if summ[key] != want:
            fail(f"summary {key} {summ[key]} != {want}")
    if len(summ["paper_solutions"]) != 7:
        fail(f"summary paper_solutions {summ['paper_solutions']}")
    if any(canary_run["timer_rows"][k] != v["rows"] for k, v in lr.items()):
        fail(f"the launches counted {canary_run['timer_rows']} rows, the "
             f"engine {lr}")
    say(f"  summary(): totals equal the stats, 7 knowns, "
        f"candidates_screened {summ['candidates_screened']:,} = "
        f"{canary_run['oracle_rows']} oracle rows + {launched:,} launched "
        f"candidates (rows counted by the launches: "
        f"{canary_run['timer_rows']}; tiled's include the pad of each "
        "run's last tile)")

    # (c)
    t1 = time.time()
    site = os.path.join(tmp, "p22", "site-packages")
    home = os.path.join(tmp, "p22", "home")
    xdg = os.path.join(home, "xdg")
    shutil.copytree(os.path.dirname(os.path.abspath(pkg.__file__)),
                    os.path.join(site, "pde_engine_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = tree_digest(site)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(HOME=home, XDG_CACHE_HOME=xdg, PYTHONPATH=site,
               PYTHONDONTWRITEBYTECODE="1")
    r = subprocess.run([sys.executable, "-c", _INSTALLED, site,
                        str(INSTALLED_ROWS)], cwd=os.path.join(tmp, "p22"),
                       env=env, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        fail(f"the installed copy failed (exit {r.returncode}):\n"
             f"{r.stdout[-2000:]}{r.stderr[-4000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    cache = os.path.join(xdg, "pde_engine_tpu_torch")
    if got["root"] != cache or not got["core"] or any(
            os.path.dirname(os.path.dirname(got[k])) != cache
            or not os.path.exists(got[k]) for k in ("core", "screen")):
        fail(f"the installed copy built {got}, not under {cache}")
    if not got["bit_equal"] or got["launches"] != 1:
        fail(f"the installed copy's universal launch: {got}")
    if tree_digest(site) != before:
        fail("the installed copy wrote inside itself")
    say(f"  installed copy (the package alone, HOME and XDG_CACHE_HOME "
        f"elsewhere): built the native core and force_free's kernels "
        f"under $XDG_CACHE_HOME/pde_engine_tpu_torch in "
        f"{got['build_s']:.1f} s, universal at {INSTALLED_ROWS:,} rows "
        f"bit-equal to its plain twin, nothing written inside the copy; "
        f"{time.time() - t1:.1f} s")
    return {"entry_rel_max": rel, "summary": summ, "installed": got}


NEEDS = {5: {4}, 6: {4}, 7: {4}, 8: {6}, 10: {4}, 11: {4, 6, 7, 8},
         12: {4}, 17: {4}, 22: {13}}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=None,
                    help="comma-separated phases to run (default: 1-13, "
                         "18-22; "
                         "1 and 2 always run; any other set prints no "
                         "result line)")
    args = ap.parse_args(argv)
    phases = set(DEFAULT_PHASES)
    if args.phases:
        phases = {1, 2} | {int(x) for x in args.phases.split(",")}
        for ph in phases:
            if not NEEDS.get(ph, set()) <= phases:
                fail(f"phase {ph} needs phases {sorted(NEEDS[ph])}")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "GPU")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "pde_engine_tpu_torch")):
        fail(f"no pde_engine_tpu_torch package beside {__file__}: run "
             "from a checkout of the repository")
    sys.path.insert(0, here)
    os.chdir(here)
    t_all = time.time()
    t_phase = {}

    def begin(k, msg):
        t_phase[k] = time.time()
        say(f"[{k}/{N_PHASES}] {msg}")

    def end(k):
        t_phase[k] = time.time() - t_phase[k]

    card = smi_line()
    begin(1, f"device: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    dev = torch.device("cuda")

    from pde_engine_tpu_torch.models import load_problem
    from pde_engine_tpu_torch.models.force_free import ForceFreeProblem
    from pde_engine_tpu_torch.parallel import cuda_engine as ce
    from pde_engine_tpu_torch.pipeline import cuda_emit_spec
    from pde_engine_tpu_torch.utils.cuda_build import build_log

    specs = {}
    for tag in ("force_free",) + tuple(FAMILIES):
        p = load_problem(tag)
        specs[tag] = cuda_emit_spec(p, p.screen_rtol)
    omega_problem = ForceFreeProblem(omega=OMEGA)
    specs[OMEGA_TAG] = cuda_emit_spec(omega_problem,
                                      omega_problem.screen_rtol)
    if specs[OMEGA_TAG].residual_key != OMEGA_TAG:
        fail(f"the Ω build's residual key is "
             f"{specs[OMEGA_TAG].residual_key!r}, not {OMEGA_TAG!r}")
    spec = specs["force_free"]
    end(1)
    begin(2, "build")
    with ThreadPoolExecutor(max_workers=len(specs)) as pool:
        for fut in [pool.submit(ce._library, sp) for sp in specs.values()]:
            fut.result()
    say(f"  {time.time() - t_phase[2]:.1f} s for the "
        f"{', '.join(specs)} libraries together (nvcc sm_90a, -fmad=false, "
        "one process each)")
    ptxas, spilled = {}, {}
    for tag, sp in specs.items():
        table, spills = ptxas_report(build_log(ce.header_text(sp)))
        ptxas[tag] = table
        geo = ce.geometry(sp)
        say(f"  {tag}: " + "; ".join(
            f"{k} {r} registers, {sm} B static shared, spills {st}/{ld} B "
            f"(stores/loads), {geo['smem'][k]:,} B dynamic shared, "
            f"{geo['blocks_per_sm'][k]} blocks per SM"
            for k, (r, sm, st, ld) in table.items())
            + f"; {geo['sms']} SMs; {geo['lanes']} lanes per candidate "
            f"group, {geo['step']} candidates per step")
        spilled.update({f"{tag} {f}": v for f, v in spills.items()
                        if any(v)})
    if spilled:
        fail(f"functions that spill (stores, loads): {spilled}")
    say("  candidates per block (blocks): " + "; ".join(
        f"{k} at {n:,} rows {ce.block_cands(spec, k, n)} "
        f"({-(-n // ce.block_cands(spec, k, n)):,})"
        for k, n in (("universal", PER_OP_ROWS), ("universal", SUPER),
                     ("structured", STRUCT_ROWS), ("structured", SUPER)))
        + "; segmented and tiled 128")
    end(2)

    family_bad = {}
    if 3 in phases:
        begin(3, "kernels vs plain torch on the card (262,144-candidate "
              "superbatches, cache of 1,048,576 seeded rows; then the "
              "order-2 builds)")
        kres, shapes = phase_kernels(spec, dev)
        for tag in FAMILIES:
            family_bad[tag] = phase_family(tag, specs[tag], dev,
                                           BUILD_SEEDS[tag])
        omega_bad = phase_family(OMEGA_TAG, specs[OMEGA_TAG], dev,
                                 BUILD_SEEDS[OMEGA_TAG], omega_problem)
        omega_ms, omega_bounds = build_ms(
            {t: specs[t] for t in ("force_free", OMEGA_TAG)}, dev,
            load_problem("force_free"))
        # each order-2 build alone: its own widths and points
        family_ms = {tag: build_ms({tag: specs[tag]}, dev,
                                   load_problem(tag))
                     for tag in FAMILIES}
        end(3)

    with tempfile.TemporaryDirectory() as tmp:
        d4, d5, d6, d7, d8, d10, d11a, d11b, d11c = (
            os.path.join(tmp, f"p{k}") for k in (4, 5, 6, 7, 8, 10, "11a",
                                                 "11b", "11c"))
        for d in (d4, d5, d6, d7, d8, d10):
            os.makedirs(d)
        phases_n, timers = {}, {}
        if 4 in phases:
            begin(4, "main path: force_free --max-depth 4 --device cuda")
            with LaunchTimer(trace=True) as timer, \
                    DepthLaunches() as by_depth4:
                ce.reset_launch_counts()
                rep4 = run_cli([], d4)
                phases_n["main"] = launches = dict(ce.LAUNCHES)
            timers["main"] = timer
            path_ms = timer.ms()
            c4 = check_main(rep4, card)
            disp4 = rep4["dispatches"]
            for k in ("segmented", "tiled"):
                if launches[k] <= 0 or disp4[k] <= 0:
                    fail(f"kernel {k} was not launched by the main path: "
                         f"launches {launches}, dispatches {disp4}")
            say(f"  7/7 knowns; counts {c4}; dispatches {disp4}; wall "
                f"{rep4['wall_seconds']:.1f} s")
            say(f"  launches (main path): {launches}; by depth "
                f"{by_depth4.by_depth}")
            lr = rep4["launched_rows"]
            for k in GROUP_KERNELS:
                rows, cands, tile_rows = (lr[k][x] for x in (
                    "rows", "candidates", "tile_rows"))
                want = cands if k == "segmented" else tile_rows
                if timer.rows[k] != rows or rows != want:
                    fail(f"{k}: {timer.rows[k]} rows launched, the engine "
                         f"counts {lr[k]}: want {want:,} rows")
                say(f"  {k}: {launches[k]} launches, {rows:,} rows launched "
                    f"for {cands:,} candidates ({rows - cands:,} pad rows"
                    + (", each in the last 512-row tile of a run"
                       if k == "tiled" else "") + "); kernel "
                    f"{path_ms[k]:.4f} ms summed (CUDA events), "
                    f"{fmt_ms(timer.device_ms(k))} ms of device time "
                    "(activity trace); per launch (rows, ms): " + ", ".join(
                        f"({n:,}, {ms:.4f})"
                        for n, ms in timer.per_launch(k)))
            if timer.trace_error:
                say(f"  no activity trace, device times not measured: "
                    f"{timer.trace_error}")
            say(f"  segmented + tiled on the main path: "
                f"{sum(path_ms.values()):.4f} ms of kernel time over "
                f"{sum(timer.rows.values()):,} live rows")
            end(4)
        if 5 in phases:
            begin(5, "structured coverage: --batch-size 4096")
            with LaunchTimer(trace=True) as timer5:
                ce.reset_launch_counts()
                rep5 = run_cli(["--batch-size", "4096",
                                "--no-report-families"], d5)
                phases_n["batch_4096"] = launches5 = dict(ce.LAUNCHES)
            timers["batch_4096"] = timer5
            disp5 = rep5["dispatches"]
            c5 = counts_of(rep5)
            for k in ("segmented", "structured", "tiled"):
                if launches5[k] <= 0:
                    fail(f"kernel {k} was not launched at --batch-size "
                         f"4096: {launches5}")
            if len(rep5["paper_solutions_found"]) != 7:
                fail("--batch-size 4096 did not find 7/7 known solutions")
            # the key sets are dispatch-order invariant; which expression
            # a key keeps is not, and only there may the verdict differ
            keys, flips = verdict_diff(os.path.join(d4, "run.db"), rep4,
                                       os.path.join(d5, "run.db"), rep5)
            say(f"  launches (--batch-size 4096): {launches5}")
            say("  keys against phase 4, per depth [in both, only in phase "
                "4, only here, kept with another expression]: "
                f"{keys}; verdict differs for {len(flips)} keys")
            for i, (d, k, ra, rb) in enumerate(flips):
                if ra[0] == rb[0]:
                    fail(f"depth {d} key {k}: {ra[0]!r} is valid={ra[1]} in "
                         f"one run and valid={rb[1]} in the other")
                if i < 20:
                    for tag, r in (("default batch", ra),
                                   ("batch 4096", rb)):
                        say(f"    depth {d} key {k}, {tag}: {r[0]!r} "
                            f"valid={r[1]} ({r[2]}; f64 relmax "
                            f"{f64_relmax(r[0])!r})")
            if {d: u for d, (u, _) in c5.items()} != \
                    {d: u for d, (u, _) in c4.items()}:
                fail(f"--batch-size 4096 uniques {c5} != default batch's "
                     f"{c4}")
            for d, (_, v) in c5.items():
                if abs(v - c4[d][1]) > VALID_SPREAD * c4[d][1]:
                    fail(f"depth {d}: --batch-size 4096 valid {v} vs "
                         f"{c4[d][1]}")
            say(f"  counts {c5}; valid within {VALID_SPREAD:.1%} of phase 4; "
                f"dispatches {disp5}; wall {rep5['wall_seconds']:.1f} s")
            st5 = timer5.per_launch("structured")
            say(f"  structured: {len(st5)} launches, "
                f"{timer5.rows['structured']:,} rows, kernel "
                f"{timer5.ms()['structured']:.4f} ms summed (CUDA events), "
                f"{fmt_ms(timer5.device_ms('structured'))} ms of device "
                "time (activity trace); per launch (rows, ms): "
                + ", ".join(f"({n:,}, {ms:.4f})" for n, ms in st5))
            end(5)
        if 6 in phases:
            begin(6, "per-op path: DiscoveryRun(force_free, SearchConfig("
                  "max_depth=4, use_segmented=False), device='cuda')")
            with LaunchTimer(trace=True) as timer6:
                ce.reset_launch_counts()
                rep6, _ = api_run(d6, 4, use_segmented=False)
                phases_n["per_op"] = launches6 = dict(ce.LAUNCHES)
            timers["per_op"] = timer6
            c6 = counts_of(rep6)
            stage_lines(rep6, card)
            if len(rep6["paper_solutions_found"]) != 7:
                fail(f"per-op path found {rep6['paper_solutions_found']}, "
                     "not 7/7 known solutions")
            if launches6["universal"] <= 0 or any(
                    launches6[k] for k in ("segmented", "structured",
                                           "tiled")):
                fail(f"per-op path launches {launches6}: want universal "
                     "only")
            keys6, flips6 = verdict_diff(os.path.join(d4, "run.db"), rep4,
                                         os.path.join(d6, "run.db"), rep6,
                                         strict=False)
            say("  keys against phase 4, per depth [in both, only in phase "
                "4, only in the per-op run, kept with another expression]: "
                f"{keys6}; verdict differs for {len(flips6)} keys")
            for d, k, ra, rb in flips6[:10]:
                for tag, r in (("phase 4", ra), ("per-op", rb)):
                    say(f"    depth {d} key {k}, {tag}: {r[0]!r} "
                        f"valid={r[1]} ({r[2]})")
            for d in EXACT:
                if c6[d] != c4[d] or keys6[d][1] or keys6[d][2]:
                    fail(f"depth {d}: per-op counts {c6[d]} / keys "
                         f"{keys6[d]} differ from phase 4's {c4[d]}")
            for d in (3, 4):
                for i, what in ((0, "uniques"), (1, "valid")):
                    if abs(c6[d][i] - c4[d][i]) > VALID_SPREAD * c4[d][i]:
                        fail(f"depth {d}: per-op {what} {c6[d][i]} not "
                             f"within {VALID_SPREAD:.1%} of phase 4's "
                             f"{c4[d][i]}")
            say(f"  7/7 knowns; counts {c6}; within {VALID_SPREAD:.1%} of "
                f"phase 4; dispatches {rep6['dispatches']}; launches "
                f"{launches6}; wall {rep6['wall_seconds']:.1f} s")
            lr6 = rep6["launched_rows"]["universal"]
            if not (timer6.rows["universal"] == lr6["rows"]
                    == lr6["candidates"]):
                fail(f"universal: {timer6.rows['universal']} rows launched, "
                     f"the engine counts {lr6}: want exactly its "
                     "candidates")
            say(f"  universal: {launches6['universal']} launches, "
                f"{lr6['rows']:,} rows launched for {lr6['candidates']:,} "
                f"candidates; kernel {timer6.ms()['universal']:.4f} ms "
                "summed (CUDA events), "
                f"{fmt_ms(timer6.device_ms('universal'))} ms of device time "
                "(activity trace); by launch size, events: "
                + json.dumps(by_size(timer6.per_launch("universal")))
                + "; device: " + json.dumps(by_size(
                    timer6.device("universal") or [])))
            end(6)
        if 7 in phases:
            begin(7, "resume: CLI --max-depth 3, then --resume-run <id> "
                  "--max-depth 4")
            ce.reset_launch_counts()
            rep7a = run_cli(["--max-depth", "3", "--no-report-families"],
                            d7)
            phases_n["resume_part"] = dict(ce.LAUNCHES)
            shutil.copytree(d7, d11a)   # phase 11's run without a sidecar
            shutil.copytree(d7, d11c)   # and its run as old as the columns
            ce.reset_launch_counts()
            rep7 = run_cli(["--resume-run", rep7a["run_id"],
                            "--no-report-families"], d7)
            phases_n["resume"] = dict(ce.LAUNCHES)
            if rep7["run_id"] != rep7a["run_id"] or counts_of(rep7) != c4:
                fail(f"resumed run {rep7['run_id']} counts "
                     f"{counts_of(rep7)} != phase 4's {c4}")
            stage_lines(rep7, card)
            ingest_beside(rep7, rep4)
            n7 = same_rows(os.path.join(d4, "run.db"), rep4,
                           os.path.join(d7, "run.db"), rep7,
                           "WHERE depth = 4")
            say(f"  depth-4 rows equal phase 4's row for row ({n7:,} rows); "
                f"launches: depth-3 run {phases_n['resume_part']}, resumed "
                f"{phases_n['resume']}; wall {rep7['wall_seconds']:.1f} s")
            end(7)
        if 8 in phases:
            begin(8, "per-op resume without a jet snapshot: depth 3, then "
                  "resumed to depth 4")
            cfg8 = dict(use_segmented=False, snapshot_jets=False)
            ce.reset_launch_counts()
            rep8a, _ = api_run(d8, 3, **cfg8)
            phases_n["no_snapshot_part"] = dict(ce.LAUNCHES)
            if os.path.exists(os.path.join(d8, "run.db.jets.d")):
                fail("snapshot_jets=False wrote a jet snapshot")
            shutil.copytree(d8, d11b)   # phase 11's run without a sidecar
            with LaunchTimer(trace=True) as timer8:
                rep8, seeded = api_run(d8, 4, resume_of=rep8a["run_id"],
                                       **cfg8)
            timers["no_snapshot_resume"] = timer8
            phases_n["no_snapshot_replay"] = seeded
            phases_n["no_snapshot_resumed"] = dict(ce.LAUNCHES)
            if seeded["universal"] <= 0:
                fail(f"the cache rebuild launched {seeded}: no universal "
                     "replay")
            n8 = same_rows(os.path.join(d6, "run.db"), rep6,
                           os.path.join(d8, "run.db"), rep8)
            say(f"  rows equal phase 6's row for row ({n8:,} rows); "
                "universal launches: "
                f"{phases_n['no_snapshot_part']['universal']} in the depth-3 "
                f"run, {seeded['universal']} replaying the cache, "
                f"{phases_n['no_snapshot_resumed']['universal']} in depth 4; "
                f"wall {rep8['wall_seconds']:.1f} s; universal kernel "
                f"{timer8.ms()['universal']:.4f} ms summed over the replay "
                "and depth 4 (CUDA events), "
                f"{fmt_ms(timer8.device_ms('universal'))} ms of device time "
                f"(activity trace), {timer8.rows['universal']:,} rows; by "
                "launch size, events: "
                + json.dumps(by_size(timer8.per_launch("universal")))
                + "; device: " + json.dumps(by_size(
                    timer8.device("universal") or [])))
            end(8)
        families = None
        if 9 in phases:
            begin(9, "families: kerr_magnetosphere, laplace and "
                  "grad_shafranov --max-depth 4, through cli.main")
            families = phase_families(tmp, card)
            end(9)
        if 10 in phases:
            begin(10, f"post-hoc: --print-run-id <phase 4's run> "
                  f"--verify-pde --heavy-validate --certify (the "
                  f"{AUDIT_LIMIT} shortest valid rows each); --find-monopole "
                  "--audit-kerr on a kerr depth-2 run")
            phase_posthoc(rep4, d4, d10)
            end(10)
        if 11 in phases:
            begin(11, "DB-rebuild resume: phases 7's and 8's depth-3 runs "
                  "without their registry sidecars, resumed to depth 4; "
                  "phase 7's as old as the struct columns")
            (phases_n["parse_path_replay"],
             phases_n["parse_path_resumed"]) = phase_db_resume(
                d4, rep4, d6, rep6, d11a, rep7a, d11b, rep8a, d11c)
            end(11)
        bench_line = None
        if 12 in phases:
            begin(12, "bench: python -m pde_engine_tpu_torch.bench 3 (the "
                  "depth-4 stream at the default batch)")
            bench_line, phases_n["bench"] = phase_bench(
                tmp, rep4, by_depth4.by_depth[4])
            end(12)
        if 13 in phases:
            begin(13, "recall canaries: no-audit force_free depth 4 "
                  "through DiscoveryEngine")
            phases_n["canary"], canary_run = phase_canary(
                card, c4 if 4 in phases else None)
            end(13)
        depth5 = {}
        for k, audit in ((14, False), (15, True)):
            if k in phases:
                begin(k, "force_free --max-depth 5 "
                      + ("(reject rows audited)" if audit
                         else "--no-audit-rejects") + " through cli.main")
                depth5[k] = phase_depth5(tmp, card, audit)
                end(k)
        if 16 in phases:
            begin(16, "laplace --max-depth 5: default batch, --batch-size "
                  "4096 and the per-op path, verdicts compared key by key")
            phase_laplace(tmp, card)
            end(16)
        if 17 in phases:
            begin(17, "host: two more fresh force_free depth-4 runs, one "
                  "with its main thread sampled, and resumes with and "
                  "without the DB's secondary indices")
            phase_host(tmp, card, c4)
            end(17)
        omega_run = None
        if 18 in phases:
            begin(18, f"Ω: force_free --omega {OMEGA} --max-depth 4 "
                  "--no-audit-rejects through cli.main, the per-op path to "
                  "depth 3, --batch-size 4096, --print-run-id --verify-pde")
            omega_run = phase_omega(tmp, card)
            end(18)
        tape_run = None
        if 19 in phases:
            begin(19, "tape engine: DiscoveryEngine(force_free, "
                  "SearchConfig(engine='tape'), device='cuda') to depth 3; "
                  "make_search_kernel on the card")
            tape_run = phase_tape(card)
            end(19)
        mesh_run = None
        configs_run = None
        if 20 in phases:
            begin(20, "mesh: --devices 1 through cli.main; [cuda:0, "
                  "cuda:0] replicated and uid-range-sharded; two "
                  "--multihost --shard-registry processes over gloo; "
                  "dryrun_multichip(2); bench --devices 1")
            mesh_run, mesh_n = phase_mesh(
                tmp, card, (os.path.join(d6, "run.db"), rep6)
                if 6 in phases else None)
            phases_n.update(mesh_n)
            end(20)
        if 21 in phases:
            deep = args.phases is not None
            begin(21, "configurations: force_free --no-special-ops to depth "
                  "4 (default batch, per-op to depth 3, --batch-size 4096), "
                  "laplace --mode sequential --heavy-checks to depth 3, "
                  f"force_free --no-prune to depth {4 if deep else 3}; "
                  "resumes without the flags, refused conflicting resumes")
            configs_run, configs_n = phase_configs(tmp, card, deep)
            phases_n.update(configs_n)
            end(21)
        surface_run = None
        if 22 in phases:
            begin(22, "library surface: load_problem, SearchConfig, ops, "
                  "dryrun.entry() on the card; summary() of phase 13's "
                  "engine; an installed copy building in the user cache")
            surface_run = phase_surface(tmp, canary_run)
            end(22)

    say("phase seconds: " + json.dumps(
        {k: round(v, 1) for k, v in sorted(t_phase.items())}))
    if families is not None:
        print(json.dumps({"families": families}), flush=True)
    if bench_line is not None:
        print(json.dumps({"bench": bench_line}), flush=True)
    if depth5:
        print(json.dumps({"depth5": depth5}), flush=True)
    if omega_run is not None:
        print(json.dumps({"omega": omega_run}), flush=True)
    if tape_run is not None:
        print(json.dumps({"tape": tape_run}), flush=True)
    if mesh_run is not None:
        print(json.dumps({"mesh": mesh_run}), flush=True)
    if configs_run is not None:
        print(json.dumps({"configs": configs_run}), flush=True)
    if surface_run is not None:
        print(json.dumps({"surface": surface_run}), flush=True)
    if phases != DEFAULT_PHASES:
        say(f"phases {sorted(phases)} passed in {time.time() - t_all:.1f} "
            "s (a subset: no result line)")
        return 0
    # every universal launch of phases 6 and 8, too long for the output
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke_launches.json"), "w") as fh:
        json.dump({ph: {"events": timers[ph].per_launch("universal"),
                        "device": timers[ph].device("universal")}
                   for ph in ("per_op", "no_snapshot_resume")}, fh)
    kernels = []
    for k, (err, ulp, ms, plain, _, _, b_ms, b_by) in kres.items():
        counts = {ph: n[k] for ph, n in phases_n.items()}
        own = OWN_PATH[k]
        if not counts[own]:
            fail(f"kernel {k} was not launched on its path ({own}): "
                 f"{counts}")
        kernels.append({
            "name": k, "route": "cuda",
            "source": "pde_engine_tpu_torch/csrc/screen_kernel.cu",
            "replaces": REPLACES[k], "launches": counts[own],
            "launches_by_phase": counts,
            "max_abs_err": err, "max_ulp_exp_log": ulp,
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "path_phase": own, "path_ms": timers[own].ms()[k],
            "path_device_ms": timers[own].device_ms(k),
            "live_rows": timers[own].rows[k]})
        pairs = timers[own].per_launch(k)
        if k == "universal":
            kernels[-1]["path"] = by_size(pairs)
            kernels[-1]["path_ms_no_snapshot_resume"] = \
                timers["no_snapshot_resume"].ms()[k]
            kernels[-1]["path_device_ms_no_snapshot_resume"] = \
                timers["no_snapshot_resume"].device_ms(k)
        else:
            kernels[-1]["path"] = [[n, round(t, 5)] for n, t in pairs]
        if k in shapes:
            kernels[-1]["path_shape"] = dict(
                shapes[k], cands_per_block=ce.block_cands(spec, k,
                                                     shapes[k]["rows"]))
        regs, _, st, ld = ptxas["force_free"][k]
        kernels[-1].update(registers=regs, spill_bytes=st + ld,
                           dyn_smem=ce.geometry(spec)["smem"][k])
        kernels[-1]["family_builds"] = {
            tag: {"registers": ptxas[tag][k][0],
                  "spill_bytes": ptxas[tag][k][2] + ptxas[tag][k][3],
                  "blocks_per_sm": ce.geometry(specs[tag])[
                      "blocks_per_sm"][k],
                  "packed_and_fp_rows_differ": 0,
                  "exp_log_jet_rows_differ": family_bad[tag][0],
                  "ms": family_ms[tag][0][tag][k],
                  "bound_ms": family_ms[tag][1][tag][k][0],
                  "bound_by": family_ms[tag][1][tag][k][1]}
            for tag in FAMILIES}
        if families is not None:
            kernels[-1]["family_launches"] = {
                tag: f["launches"][k] for tag, f in families.items()}
        w_regs, _, w_st, w_ld = ptxas[OMEGA_TAG][k]
        kernels[-1]["omega_build"] = {
            "residual_key": OMEGA_TAG, "registers": w_regs,
            "spill_bytes": w_st + w_ld,
            "blocks_per_sm": ce.geometry(specs[OMEGA_TAG])["blocks_per_sm"][k],
            "ms": omega_ms[OMEGA_TAG][k],
            "force_free_ms_same_turns": omega_ms["force_free"][k],
            "bound_ms": omega_bounds[OMEGA_TAG][k][0],
            "bound_by": omega_bounds[OMEGA_TAG][k][1],
            "max_abs_err": omega_bad[1], "max_ulp_exp_log": omega_bad[2],
            "exp_log_jet_rows_differ": omega_bad[0],
            "launches": {ph: n[k] for ph, n in omega_run["launches"].items()}}
        kernels[-1]["config_launches"] = {
            ph: n[k] for ph, n in configs_run["launches"].items()}
    say(f"total {time.time() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
