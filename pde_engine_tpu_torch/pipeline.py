"""Discovery pipeline on one torch device: enumerate → screen/fingerprint
on the device → dedup → float64 recheck → (optional) symbolic confirm.

Counterpart of ``pde_engine_tpu/pipeline.py`` on one device.  Every depth
≥ 2 streams through the screen kernels of ``parallel/cuda_engine.py``, on
a CUDA device as hand-written kernels and on the CPU as their plain torch
twins: by default the segmented superbatch path (mixed, structured and
tiled buffers), and with ``SearchConfig(use_segmented=False)`` the per-op
path (one ``universal`` launch per op batch).  With
``SearchConfig(engine="tape")`` every depth ≥ 2 candidate is instead
evaluated from its whole tape by the float64 oracle, as in the JAX
package's tape engine.  Resume seeds the jet cache from a snapshot and
replays the missing composed rows through the same kernels.  The host
side (enumerator, ``DedupMap``, reject rows, the gray float64 overlap) is
the port's copy of the JAX package's.

With a ``mesh`` (``parallel/mesh.CandidateMesh``: ``--devices K``, or
one device per process under ``--multihost``) every depth >= 2 takes the
per-op path, as in the JAX package: each op batch is split into the
mesh's shards, one ``universal`` launch per shard over a replicated
cache or, with ``shard_cache``, over operand rows rebuilt from a
uid-range-sharded cache (``parallel/incremental.py``); across processes
the shards' verdicts and jets are all-gathered so that every process
ingests the same rows (``parallel/distributed.py``), and with
``shard_registry`` each process keeps only its slice of the dedup map
(``_dedup_sharded``) and only the writer persists verdicts.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .enumerator import Candidate, Enumerator
from .ops.interpreter import eval_jets_np, eval_jets_np_many
from .ops.jets import n_coeffs
from .parallel import cuda_engine
from .parallel.incremental import OP_INDEX, OP_ORDER, JetCache
from .parallel.mesh import shard_ranges
from .parallel.search import (ScreenResult, informative_points,
                              snap_fp_jets_np, unpack_screen_result_compact,
                              verdicts_from_jets_np)
from .utils import spans
from .utils.config import SearchConfig
from .utils.hashing import FP_MASK, STRUCT_TAG, op_salt, struct_key_for_expr

# See pde_engine_tpu/pipeline.py: a candidate is constant in the f64
# oracle when its gradient is below 1e-12 of its value magnitude at every
# collocation point.
_CONST64_RTOL = 1e-12
TILE = 512


def resolve_device(device) -> torch.device:
    """The explicit device of a run.  ``cuda`` without a usable GPU
    raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _is_contiguous_run(x: np.ndarray) -> bool:
    return (int(x[-1]) - int(x[0]) == x.size - 1
            and bool((np.diff(x) == 1).all()))


def structured_run_kind(a_u: np.ndarray, b_u: Optional[np.ndarray],
                        pos: int, n: int) -> Optional[str]:
    """Classify the ``[pos, pos+n)`` slice of an op segment for the
    gather-bypass kernels: "b" when ``a`` is constant and ``b`` a
    contiguous uid range, "a" when ``b`` is constant (or the op is unary)
    and ``a`` contiguous, else None."""
    a = a_u[pos:pos + n]
    if b_u is None:
        return "a" if _is_contiguous_run(a) else None
    b = b_u[pos:pos + n]
    if a[0] == a[-1]:
        if _is_contiguous_run(b) and not (a != a[0]).any():
            return "b"
    elif b[0] == b[-1]:
        if _is_contiguous_run(a) and not (b != b[0]).any():
            return "a"
    return None


def _run_operands(kind: str, a_u: np.ndarray, b_u: Optional[np.ndarray],
                  pos: int) -> Tuple[int, int]:
    """(constant row, first row of the contiguous run) of a run-shaped
    slice starting at ``pos`` (see :func:`structured_run_kind`)."""
    if kind == "b":
        return int(a_u[pos]), int(b_u[pos])
    return (0 if b_u is None else int(b_u[pos])), int(a_u[pos])


@dataclass
class Launch:
    """One screen-kernel launch of the segmented path, as
    :func:`route_segmented` lays it out."""
    kernel: str   # "segmented", "structured" or "tiled"
    rows: int     # rows launched; tiled launches whole 512-row tiles
    # (op name, first row in the launch, a uids, b uids or None), in
    # ingest order
    segs: List[Tuple[str, int, np.ndarray, Optional[np.ndarray]]]
    # segmented: (ab [rows, 2], row_ops [rows]); tiled: (starts,
    # const_uid, opkind), one entry per tile
    index: Tuple[np.ndarray, ...] = ()
    # structured: (const_uid, big0, op id, "a" or "b")
    run: Tuple = ()

    @property
    def candidates(self) -> int:
        return sum(s[2].size for s in self.segs)


def route_segmented(batches: Iterable, super_rows: int, tiled_min_rows: int,
                    capacity: Callable[[], int], structured: bool = True,
                    tiled: bool = True) -> Iterator[Launch]:
    """Lay the enumerator's ``(op_name, a_u, b_u)`` batches out as
    launches, in the order the engine launches and ingests them:

    - ``structured`` for a run of ``super_rows`` candidates with one
      constant row and a contiguous uid range (the mixed superbatch
      filled so far goes out first);
    - ``tiled`` for a run of at least ``tiled_min_rows``, packed as
      512-row tiles (the run's last tile is padded; a run whose padded
      tail would read past ``capacity()`` rows takes the mixed path);
    - ``segmented`` for the rest, one op id per row, a superbatch being
      full when its segments, each rounded up to whole 512-row tiles as
      in the JAX engine, fill ``super_rows``.

    The generator is lazy and reads ``capacity()`` as it routes, so a
    caller that appends cache rows between launches sees each decision
    made on the current cache."""
    n_tiles = super_rows // TILE
    ab = np.zeros((super_rows, 2), np.int32)
    row_ops = np.zeros(super_rows, np.int32)
    segs: List = []
    fill_tiles = fill_rows = 0
    t_starts = np.zeros(n_tiles, np.int32)
    t_const = np.zeros(n_tiles, np.int32)
    t_opkind = np.zeros(n_tiles, np.int32)
    t_segs: List = []
    t_fill = 0

    def mixed() -> Launch:
        nonlocal ab, row_ops, segs, fill_tiles, fill_rows
        ln = Launch("segmented", fill_rows, segs,
                    (ab[:fill_rows], row_ops[:fill_rows]))
        ab = np.zeros((super_rows, 2), np.int32)
        row_ops = np.zeros(super_rows, np.int32)
        segs = []
        fill_tiles = fill_rows = 0
        return ln

    def tiles() -> Launch:
        nonlocal t_starts, t_const, t_opkind, t_segs, t_fill
        ln = Launch("tiled", t_fill * TILE, t_segs,
                    (t_starts[:t_fill], t_const[:t_fill],
                     t_opkind[:t_fill]))
        t_starts = np.zeros(n_tiles, np.int32)
        t_const = np.zeros(n_tiles, np.int32)
        t_opkind = np.zeros(n_tiles, np.int32)
        t_segs = []
        t_fill = 0
        return ln

    for op_name, a_u, b_u in batches:
        opid = OP_INDEX[op_name]
        pos = 0
        while pos < a_u.size:
            rem = a_u.size - pos
            if structured and rem >= super_rows:
                kind = structured_run_kind(a_u, b_u, pos, super_rows)
                if kind is not None:
                    if fill_tiles:
                        yield mixed()
                    const_uid, big0 = _run_operands(kind, a_u, b_u, pos)
                    yield Launch(
                        "structured", super_rows,
                        [(op_name, 0, a_u[pos:pos + super_rows],
                          None if b_u is None
                          else b_u[pos:pos + super_rows])],
                        run=(const_uid, big0, opid, kind))
                    pos += super_rows
                    continue
            if tiled and rem >= tiled_min_rows:
                kind = structured_run_kind(a_u, b_u, pos, rem)
                if kind is not None:
                    const_uid, big0 = _run_operands(kind, a_u, b_u, pos)
                    if big0 + (-(-rem // TILE)) * TILE <= capacity():
                        opk = opid * 2 + (1 if kind == "b" else 0)
                        off = 0
                        while off < rem:
                            room = (n_tiles - t_fill) * TILE
                            if room == 0:
                                yield tiles()
                                continue
                            take = min(rem - off, room)
                            used = -(-take // TILE)
                            tl = slice(t_fill, t_fill + used)
                            t_starts[tl] = (big0 + off
                                            + TILE * np.arange(used))
                            t_const[tl] = const_uid
                            t_opkind[tl] = opk
                            t_segs.append((
                                op_name, t_fill * TILE,
                                a_u[pos + off:pos + off + take],
                                None if b_u is None
                                else b_u[pos + off:pos + off + take]))
                            t_fill += used
                            off += take
                        pos += rem
                        continue
            room_rows = (n_tiles - fill_tiles) * TILE
            if room_rows == 0:
                yield mixed()
                continue
            take = min(rem, room_rows)
            start = fill_rows
            ab[start:start + take, 0] = a_u[pos:pos + take]
            if b_u is not None:
                ab[start:start + take, 1] = b_u[pos:pos + take]
            row_ops[start:start + take] = opid
            segs.append((op_name, start, a_u[pos:pos + take],
                         None if b_u is None else b_u[pos:pos + take]))
            fill_tiles += -(-take // TILE)
            fill_rows += take
            pos += take
    if t_fill:
        yield tiles()
    if fill_tiles:
        yield mixed()


def tally_launch(t: List[int], rows: int, sizes) -> None:
    """Add a launch of ``rows`` rows holding candidate segments of
    ``sizes`` to ``t`` = [rows, candidates, rows of the 512-row tiles
    that hold a candidate]."""
    t[0] += rows
    t[1] += sum(sizes)
    t[2] += sum(-(-m // TILE) * TILE for m in sizes)


def launched_rows_of(table: Dict[str, List[int]]
                     ) -> Dict[str, Dict[str, int]]:
    return {k: dict(zip(("rows", "candidates", "tile_rows"), v))
            for k, v in table.items()}


def launch_screen(spec: cuda_engine.ScreenSpec, cache: JetCache,
                  ln: Launch, index: Tuple[torch.Tensor, ...], spoints,
                  fpoints, plain: bool = False):
    """Launch ``ln`` over ``cache`` through its ``cuda_engine`` entry point
    (with ``plain``, its plain torch twin); ``index`` holds ``ln.index``
    as tensors on the cache's device.  Returns the entry point's
    ``(packed, jets, fj)``."""
    fn = getattr(cuda_engine, ln.kernel + ("_ref" if plain else ""))
    if ln.kernel == "structured":
        const_uid, big0, op_id, big = ln.run
        return fn(spec, cache.screen, cache.fp, const_uid, big0, op_id,
                  spoints, fpoints, big, ln.rows)
    args = (spec, cache.screen, cache.fp, *index, spoints, fpoints)
    return fn(*args, ln.rows) if ln.kernel == "tiled" else fn(*args)


def _const_in_f64_batch(jets: np.ndarray) -> np.ndarray:
    """Per-candidate constant flag for [N, P, T] float64 jets (fully
    relative: grad vs value magnitude)."""
    grad = np.abs(jets[..., 1:3]).max(axis=(-1, -2))
    mag = np.abs(jets[..., 0]).max(axis=-1)
    return grad <= _CONST64_RTOL * mag


def _const_in_f64(jets: np.ndarray) -> bool:
    return bool(_const_in_f64_batch(jets[None])[0])


@dataclass(slots=True)
class Row:
    """One stored expression (column parity with the reference's
    expressions_<run_id> table)."""
    id: int
    expression: str
    normalized: Optional[str]
    signature: str
    depth: int
    validation_status: str = "completed"
    is_valid: bool = False
    validation_reason: str = ""
    validator_method: str = ""
    is_paper_solution: bool = False
    paper_solution_name: Optional[str] = None
    heavy_is_valid: Optional[bool] = None
    heavy_reason: Optional[str] = None
    validator_math: str = ""
    validator_evidence: str = ""
    struct_op: Optional[int] = None
    struct_a: Optional[int] = None
    struct_b: Optional[int] = None


@dataclass
class DepthStats:
    depth: int
    candidates: int = 0
    unique: int = 0
    valid: int = 0
    seconds: float = 0.0
    t_enum: float = 0.0       # host candidate generation
    t_device: float = 0.0     # kernel launch + result transfer
    t_ingest: float = 0.0     # dedup + verdicts + rows
    t_gray: float = 0.0       # batched f64 rechecks
    # the rest only with PDE_INGEST_TIMERS set (utils/spans.py): seconds
    # per section of _ingest_vec within t_ingest, the JAX package's names;
    # {name: {"n", "s", "self"}} of the spans that ended in this depth;
    # counters; (name, start, end, parent, thread) of each span but the
    # ingest sections
    ingest_sections: Dict[str, float] = field(default_factory=dict)
    spans: Dict[str, Dict[str, float]] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    span_events: List[Tuple[str, float, float, Optional[str], str]] = field(
        default_factory=list)


# the fields that the JAX package's DepthStats lacks
TRACED = ("ingest_sections", "spans", "counts", "span_events")


class _Passer:
    """Lazy stand-in for a screen passer's Unique (tape and display string
    materialize on demand)."""

    __slots__ = ("uid", "_enum", "_tape", "_expr")

    def __init__(self, enum: Enumerator, uid: int):
        self.uid = uid
        self._enum = enum
        self._tape = None
        self._expr = None

    @property
    def tape(self):
        if self._tape is None:
            self._tape = self._enum.tape_of(self.uid)
        return self._tape

    @property
    def expr_str(self) -> str:
        if self._expr is None:
            self._expr = self._enum.expr_str_of(self.uid)
        return self._expr

    @property
    def has_var(self) -> bool:
        return bool(self._enum.f_has_var[self.uid])


class DiscoveryEngine:

    def __init__(self, problem, config: Optional[SearchConfig] = None,
                 device="cuda", mesh=None):
        from .parallel.distributed import (is_writer, process_count,
                                           registry_shard)
        from .utils.hostmem import tune_allocator
        from .utils.native import DedupMap
        tune_allocator()
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None:
            if mesh.home.type != self.device.type:
                raise ValueError(f"mesh {mesh} for a run on "
                                 f"{self.device.type}")
            self.device = mesh.home
        on_gpu = self.device.type == "cuda"
        self.problem = problem
        self.config = config or SearchConfig()
        if self.config.engine not in ("incremental", "tape"):
            raise ValueError(f"unknown engine {self.config.engine!r}: "
                             "'incremental' or 'tape'")
        if self.config.engine == "tape" and (
                mesh is not None or self.config.shard_cache
                or self.config.shard_registry):
            raise ValueError("the tape engine runs on one device: a mesh, "
                             "shard_cache and shard_registry are the "
                             "incremental engine's")
        if mesh is not None and self.config.use_segmented:
            raise ValueError("a mesh takes the per-op path: "
                             "use_segmented is a one-device path")
        # one process per device across processes (--multihost): the
        # shards' verdicts and jets are all-gathered
        self._multihost = mesh is not None and process_count() > 1
        # registry sharding (SearchConfig.shard_registry): across
        # processes each dedup map holds the keys it owns (key mod
        # world), and only the writer persists verdicts
        self._reg_rank, self._reg_world = 0, 1
        self.persist_host = True
        if self.config.shard_registry and mesh is not None:
            self._reg_rank, self._reg_world = registry_shard()
            if self._reg_world > 1:
                self.persist_host = is_writer()
        # uid-range cache sharding (SearchConfig.shard_cache): device d
        # holds the rows [d*C/K, (d+1)*C/K), so the parent window scales
        # with the mesh
        self._cache_sharded = bool(self.config.shard_cache
                                   and mesh is not None)
        if self.config.shard_cache and mesh is None:
            raise ValueError("shard_cache requires a mesh "
                             "(--devices N / DiscoveryEngine(mesh=...))")
        if self._cache_sharded and self._multihost:
            raise ValueError("shard_cache + multihost is not supported; "
                             "use --shard-registry for multi-process "
                             "memory scaling")
        self.mesh_survivors = None
        self.enumerator = Enumerator(
            problem,
            include_special_ops=self.config.include_special_ops,
            prune=self.config.prune,
            spill_dir=self.config.spill_strings)
        if self.config.spill_strings is not None:
            if self.enumerator.arena is None:
                print("  [mem] --spill-strings ignored: native string "
                      "arena unavailable (C core not loaded); strings "
                      "stay on the Python path", flush=True)
            elif not self.enumerator.arena.spilled:
                print(f"  [mem] string-arena spill to "
                      f"{self.config.spill_strings} unavailable; strings "
                      "stay in RAM", flush=True)
        if self.config.use_native is False:
            self.enumerator.arena = None  # exercise the Python string path
            self.enumerator.allow_native_tapes = False
        self.screen_rtol = (self.config.screen_rtol
                            if self.config.screen_rtol is not None
                            else problem.screen_rtol)
        self.confirm_rtol = (self.config.confirm_rtol
                             if self.config.confirm_rtol is not None
                             else problem.confirm_rtol)
        if self.config.batch_size is None:
            # auto: one 262,144-candidate superbatch per launch on the GPU,
            # small batches to keep the CPU path snappy
            self.config.batch_size = 262144 if on_gpu else 16384
        self.fp_to_uid = DedupMap(
            force_python=(self.config.use_native is False),
            cap_hint=(1 << 26) if on_gpu else (1 << 16))
        self.native_sink = None
        self.rows: List[Row] = []
        self.n_rows = 0
        self.last_expr = ""
        self._keep_rows = True
        self.id_offset = 0
        self.stats: List[DepthStats] = []
        self.valid_rows: List[Row] = []
        self._spoints = torch.as_tensor(problem.screen_points,
                                        dtype=torch.float32,
                                        device=self.device)
        self._fpoints = torch.as_tensor(problem.fingerprint_points,
                                        dtype=torch.float32,
                                        device=self.device)
        self._spec = cuda_emit_spec(problem, float(self.screen_rtol))
        mcr = self.config.max_cache_rows
        if mcr is None:
            # ~11 GiB budget over the family's jet-row bytes (the JAX
            # engine's auto rule)
            row_bytes = 4 * (
                len(problem.screen_points) * n_coeffs(problem.residual_order)
                + len(problem.fingerprint_points) * 3)
            mcr = max(1 << 20, (20_000_000 * 552) // row_bytes)
        # the budget is per device: a sharded cache holds one slice of it
        # on each mesh device
        self.cache_row_limit = mcr * (mesh.size if self._cache_sharded
                                      else 1)
        self.cache = JetCache(
            n_screen=len(problem.screen_points),
            t_screen=n_coeffs(problem.residual_order),
            n_fp=len(problem.fingerprint_points),
            device=self.device,
            initial_capacity=(1 << 20) if on_gpu else (1 << 14),
            grow_quantum=(1 << 20) if on_gpu else None,
            mesh=mesh, sharded=self._cache_sharded)
        self.cache.row_limit = self.cache_row_limit
        self._known_fp: Dict[str, np.ndarray] = {}
        self._known_sympy = {}
        self.candidates_screened = 0
        self.segmented_dispatches = 0   # mixed-op superbatches
        self.structured_dispatches = 0  # full-run gather-bypass batches
        self.tiled_dispatches = 0       # per-tile gather-bypass batches
        self.universal_dispatches = 0   # per-op batches
        self.shard_launches = 0         # their non-empty shards on a mesh
        # per kernel: [rows launched, candidates among them, rows of the
        # 512-row tiles that hold a candidate]
        self.launch_rows: Dict[str, List[int]] = {
            k: [0, 0, 0] for k in ("segmented", "structured", "tiled",
                                   "universal")}
        self.device_seconds = 0.0
        self.errors = 0
        self._gray: List[Tuple[Candidate, dict, int]] = []
        # one overlap worker for the gray f64 numerics (see _gray_numeric)
        self._gray_pool = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="gray")
        self._gray_done: List = []
        self._math_def = problem.describe().get("math_definition", "")
        self._prepare_known_solutions()

    # ------------------------------------------------------------------
    # Device evaluation
    # ------------------------------------------------------------------

    def _bucket_len(self, L: int) -> int:
        for b in self.config.buckets:
            if L <= b:
                return b
        return 1 << (L - 1).bit_length()

    def _unpack_start(self, packed, out_f):
        """Fetch the packed verdicts and gather the passers' fingerprint
        rows on the device."""
        cu = unpack_screen_result_compact(
            packed.cpu().numpy(), len(self.problem.fingerprint_points))
        rows = None
        if cu.n_passers:
            idx = torch.from_numpy(cu.passer_idx.astype(np.int64))
            rows = out_f[idx.to(self.device)]
        return cu, rows

    def _unpack_finish(self, cu, rows) -> ScreenResult:
        """Copy the passer rows to the host and scatter them into the
        ScreenResult."""
        if rows is not None:
            cu.sr.fp_vals[cu.passer_idx] = rows.cpu().numpy()
        return cu.sr

    def _eval_tape_groups(self, cands: List[Candidate]):
        """Evaluate arbitrary tapes via the batched float64 NumPy oracle
        (primitives and known solutions).  Yields (group, sr, out_s,
        out_f) with the jets as float32 tensors on the engine's device."""
        CHUNK = 4096
        groups: Dict[int, List[int]] = {}
        for i, c in enumerate(cands):
            groups.setdefault(self._bucket_len(len(c.tape)), []).append(i)
        consts = self.problem.consts.as_array(np.float64)
        for bucket, idxs in sorted(groups.items()):
            for lo in range(0, len(idxs), CHUNK):
                group = [cands[i] for i in idxs[lo:lo + CHUNK]]
                tapes = np.stack([c.tape.padded(bucket) for c in group])
                lengths = np.array([len(c.tape) for c in group],
                                   dtype=np.int64)
                jets = eval_jets_np_many(tapes, lengths, consts,
                                         self.problem.screen_points,
                                         self.problem.residual_order)
                fj = eval_jets_np_many(tapes, lengths, consts,
                                       self.problem.fingerprint_points, 1)
                # tapes that leave the domain overflow on purpose: their
                # non-finite jets are rejected by the verdicts
                with np.errstate(over="ignore", invalid="ignore"):
                    sr = verdicts_from_jets_np(
                        jets, fj, self.problem.screen_points,
                        self.problem.residual_fn, float(self.screen_rtol))
                    jets32 = jets.reshape(jets.shape[0], -1).astype(
                        np.float32)
                out_s = torch.from_numpy(np.ascontiguousarray(jets32)
                                         ).to(self.device)
                # cache rows carry the grid-SNAPPED fingerprint jets
                out_f = torch.from_numpy(np.ascontiguousarray(
                    sr.fp_vals.astype(np.float32))).to(self.device)
                self.candidates_screened += len(group)
                yield group, sr, out_s, out_f

    @staticmethod
    def _ev_at(sr: ScreenResult, j: int):
        """Per-candidate view of a (numpy) ScreenResult."""
        return {
            "screen_ok": bool(sr.screen_ok[j]),
            "rel_max": float(sr.rel_max[j]),
            "nonfinite": bool(sr.nonfinite[j]),
            "is_const": bool(sr.is_const[j]),
            "fp": (int(sr.fp_a[j]), int(sr.fp_b[j])),
            "fp_finite": bool(sr.fp_finite[j]),
            "fp_vals": sr.fp_vals[j],
        }

    # ------------------------------------------------------------------
    # Known solutions
    # ------------------------------------------------------------------

    def _prepare_known_solutions(self):
        """Fingerprint the known solutions so generated matches can be
        tagged."""
        knowns = list(self.problem.known_solutions.items())
        if not knowns:
            return
        cands = []
        for expr_str, name in knowns:
            t = self.problem.parse(expr_str)
            cands.append(Candidate(depth=0, expr_str=expr_str, top_op="",
                                   has_var=True, tape=t,
                                   consts=self.problem.consts))
        for group, sr, _, _ in self._eval_tape_groups(cands):
            for j, cand in enumerate(group):
                if bool(sr.fp_finite[j]):
                    name = self.problem.known_solutions[cand.expr_str]
                    self._known_fp[name] = np.asarray(sr.fp_vals[j],
                                                      dtype=np.float64)
                    self._known_sympy[name] = self.problem.tape_to_sympy(
                        cand.tape)

    def _match_known(self, cand: Candidate, fp_vals) -> Optional[str]:
        """Tolerance match on fingerprint values, gated by an exact SymPy
        equality check."""
        import sympy as sp
        v = np.asarray(fp_vals, dtype=np.float64)
        for name, kv in self._known_fp.items():
            denom = np.abs(kv) + 1.0
            if np.max(np.abs(v - kv) / denom) < 1e-3:
                try:
                    u = self.problem.tape_to_sympy(cand.tape)
                    if sp.simplify(u - self._known_sympy[name]) == 0:
                        return name
                except Exception:
                    continue
        return None

    # ------------------------------------------------------------------
    # Stages 2-4
    # ------------------------------------------------------------------

    def _recheck_f64(self, cand: Candidate) -> Tuple[bool, float]:
        jets = eval_jets_np(cand.tape.rows, len(cand.tape),
                            self.problem.consts.as_array(np.float64),
                            self.problem.screen_points,
                            self.problem.residual_order)
        if _const_in_f64(jets):
            return False, float("inf")
        res, scale = self.problem.residual_fn(
            jets, self.problem.screen_points, np)
        with np.errstate(invalid="ignore"):
            rel = np.abs(res) / (scale + 1e-300)
        if not (np.isfinite(res).all() and np.isfinite(scale).all()):
            return False, float("inf")
        ok_pt = informative_points(res, scale, jets)
        if not ok_pt.any():
            return False, float("inf")
        relmax = float(np.where(ok_pt, rel, 0.0).max())
        return relmax < self.confirm_rtol, relmax

    def _confirm_symbolic(self, cand: Candidate) -> Tuple[Optional[bool], str]:
        """Returns (verdict, method). verdict None => skipped."""
        if not self.config.confirm_symbolic:
            return None, "numeric"
        if len(cand.expr_str) > self.config.sympy_len_limit:
            return None, "numeric(len-limit)"
        try:
            u = self.problem.tape_to_sympy(cand.tape)
            return self.problem.exact_zero_residual(u), "symbolic"
        except Exception:
            self.errors += 1
            return None, "numeric(symbolic-error)"

    # ------------------------------------------------------------------
    # Ingestion (dedup + verdicts + cache append)
    # ------------------------------------------------------------------

    @staticmethod
    def _fp_keys(sr: ScreenResult, n: int, struct_keys: np.ndarray
                 ) -> np.ndarray:
        """uint64 dedup keys: fingerprint hash when finite, structural
        (op, a, b) hash otherwise; bit 63 separates the two kinds."""
        keys = ((sr.fp_a[:n].astype(np.uint64) << np.uint64(32))
                | sr.fp_b[:n].astype(np.uint64)) & np.uint64(FP_MASK)
        nf = ~sr.fp_finite[:n]
        if nf.any():
            keys = keys.copy()
            keys[nf] = struct_keys[nf]
        return keys

    def _ingest(self, cands: List[Candidate], sr: ScreenResult, depth: int,
                st: DepthStats, on_row=None, out_s=None, out_f=None):
        kept: List[int] = []
        fp_to_uid = self.fp_to_uid
        fpa, fpb, fp_finite = sr.fp_a, sr.fp_b, sr.fp_finite
        st.candidates += len(cands)
        for j, cand in enumerate(cands):
            if fp_finite[j]:
                fp = (((int(fpa[j]) << 32) | int(fpb[j])) & FP_MASK)
            else:
                fp = struct_key_for_expr(cand.expr_str)
            if fp in fp_to_uid:
                continue
            u = self.enumerator.add_unique(cand)
            fp_to_uid[fp] = u.uid
            kept.append(j)
            st.unique += 1
            self._verdict(u, self._ev_at(sr, j), depth, st, on_row, fp)
        if out_s is not None and kept:
            self._append_kept(out_s, out_f, kept)

    def _append_kept(self, out_s, out_f, kept: List[int]):
        """Append the kept batch rows' jets at the cache tail."""
        idx = torch.as_tensor(kept, dtype=torch.int64, device=self.device)
        self.cache.append_gathered(out_s, out_f, idx)

    def _dedup_sharded(self, keys: np.ndarray, base_uid: int) -> np.ndarray:
        """Sharded-registry dedup (SearchConfig.shard_registry): this
        process probes and stores only the keys it owns (key mod world),
        the processes' new-key masks are OR-combined (ownership
        partitions the batch positions, so the union is disjoint), and
        every process derives the same global first-occurrence set, uids
        consecutive in batch order as in the unsharded insert_batch.  The
        owned new keys then get their global uids."""
        from .parallel.distributed import or_reduce_mask
        n = keys.size
        world = np.uint64(self._reg_world)
        rank = np.uint64(self._reg_rank)
        mine = np.nonzero(keys % world == rank)[0]
        local_new = self.fp_to_uid.insert_batch(keys[mine], base_uid=0)
        my_new = mine[local_new]
        mask = np.zeros(n, np.bool_)
        mask[my_new] = True
        new_idx = np.nonzero(or_reduce_mask(mask))[0].astype(np.int64)
        if my_new.size:
            pos = np.searchsorted(new_idx, my_new)
            self.fp_to_uid.set_batch(keys[my_new],
                                     base_uid + pos.astype(np.int64))
        return new_idx

    def keep_owned_keys(self):
        """Drop from the dedup map the keys this process does not own (a
        sharded-registry resume that rebuilt the whole map from the DB
        rows)."""
        from .utils.native import DedupMap
        ks, vs = self.fp_to_uid.items_arrays()
        own = (ks % np.uint64(self._reg_world)) == np.uint64(self._reg_rank)
        owned = DedupMap(force_python=(self.config.use_native is False),
                         cap_hint=max(int(own.sum()) * 2, 1 << 16))
        owned.set_batch(ks[own], vs[own].astype(np.int64))
        self.fp_to_uid = owned

    def _ingest_vec(self, op_name: str, a_u: np.ndarray,
                    b_u: Optional[np.ndarray], sr: ScreenResult,
                    depth: int, st: DepthStats, on_row=None,
                    out_s=None, out_f=None, append_cache: bool = True,
                    on_rows=None, retain_strings: bool = True,
                    row_offset: int = 0, defer_append_to=None):
        """Vectorized ingestion: dedup, unique registration, verdict
        classification and reject-row emission at array level;
        per-candidate Python only for screen passers."""
        n = a_u.size
        st.candidates += n

        with spans.span("ingest.keys"):
            bb = b_u if b_u is not None else np.zeros(n, np.int32)
            with np.errstate(over="ignore"):
                struct = (a_u.astype(np.uint64)
                          * np.uint64(0x9E3779B97F4A7C15)
                          ^ bb.astype(np.uint64)
                          * np.uint64(0xC2B2AE3D27D4EB4F)
                          ^ np.uint64(op_salt(op_name)))
            struct |= np.uint64(STRUCT_TAG)
            keys = self._fp_keys(sr, n, struct)

        with spans.span("ingest.dedup"):
            enum = self.enumerator
            if self._reg_world > 1:
                new_idx = self._dedup_sharded(keys, enum.count_uniques())
            else:
                new_idx = self.fp_to_uid.insert_batch(
                    keys, base_uid=enum.count_uniques())
        if new_idx.size == 0:
            return
        k_new = int(new_idx.size)

        persist = self.persist_host
        with spans.span("ingest.register"):
            uid0, exprs = enum.add_uniques_bulk(
                op_name, a_u[new_idx],
                None if b_u is None else b_u[new_idx], depth,
                retain_strings=retain_strings and persist,
                arena_strings=(persist and (self.config.audit_rejects
                                            or retain_strings)))
            if (persist and exprs is None and self.native_sink is None
                    and self.config.audit_rejects):
                blob = enum.arena.blob(
                    np.arange(uid0, uid0 + k_new, dtype=np.int64))
                exprs = [s.decode() for s in blob.split(b"\x00")[:-1]]
        newkeys = keys[new_idx]
        st.unique += k_new

        if not persist:
            # a non-writer of a sharded-registry run: verdicts, reject
            # rows and gray rechecks are the writer's; uid assignment and
            # the cache do not depend on them
            self.n_rows += k_new
            with spans.span("ingest.cache_append"):
                self._append_cache_section(out_s, out_f, k_new, new_idx,
                                           append_cache, defer_append_to,
                                           row_offset)
            return

        with spans.span("ingest.verdicts"):
            has_var = enum.f_has_var[uid0:uid0 + k_new]
            is_const = sr.is_const[new_idx] | ~has_var
            nonfin = ((~sr.fp_finite[new_idx] | sr.nonfinite[new_idx])
                      & ~is_const)
            passing = sr.screen_ok[new_idx] & ~is_const & ~nonfin

        with spans.span("ingest.rejects"):
            self._emit_rejects_bulk(
                uid0, exprs, newkeys, depth, sr, new_idx,
                is_const, nonfin, passing, on_row, on_rows)

        with spans.span("ingest.passers"):
            pass_locals = np.nonzero(passing)[0]
            for local in pass_locals.tolist():
                uid = uid0 + local
                u = _Passer(enum, uid)
                if exprs is not None:
                    u._expr = exprs[local]
                ev = self._ev_at(sr, int(new_idx[local]))
                key = int(newkeys[local])
                if ev["rel_max"] < self.config.f64_skip_below:
                    self._finalize_pass(u, ev, ev["rel_max"], "screen",
                                        depth, st, on_row, key)
                else:
                    self._gray.append((u, ev, key))

        with spans.span("ingest.cache_append"):
            self._append_cache_section(out_s, out_f, k_new, new_idx,
                                       append_cache, defer_append_to,
                                       row_offset)

    def _append_cache_section(self, out_s, out_f, k_new: int,
                              new_idx: np.ndarray, append_cache: bool,
                              defer_append_to, row_offset: int):
        if out_s is None or not k_new or not append_cache:
            return
        if defer_append_to is not None:
            # segmented superbatch: one append per launch, uid order kept
            defer_append_to.extend((new_idx + row_offset).tolist())
        else:
            room = self.cache_row_limit - self.cache.n
            if room > 0:
                self._append_kept(out_s, out_f, new_idx[:room].tolist())

    _R_CONST = "Zero gradient (constant expression)"
    _R_NONFIN = "Non-finite on safe domain (rejected)"
    _EV_FMT = ('{"rel_max": %s, "screen_ok": %s, "nonfinite": %s,'
               ' "is_const": %s, "fp_finite": %s, "n_screen_points": %d,'
               ' "stage": "screen"}')

    @staticmethod
    def _fmt_rel(x: float) -> str:
        """JSON-parseable float (Infinity/NaN spellings)."""
        if x != x:
            return "NaN"
        if x == float("inf"):
            return "Infinity"
        if x == float("-inf"):
            return "-Infinity"
        return "%.6e" % x

    def _emit_rejects_bulk(self, uid0, exprs, keys, depth, sr, new_idx,
                           is_const, nonfin, passing, on_row, on_rows):
        """Emit the constant / non-finite / screen-fail reject rows through
        the native sqlite writer, as DB tuples, or as Rows."""
        store_const = self.config.store_constants
        if not self.config.audit_rejects:
            n_skip = int((~passing).sum())
            if not store_const:
                n_skip -= int(is_const.sum())
            self.n_rows += max(n_skip, 0)
            if exprs:
                self.last_expr = exprs[-1]
            elif len(is_const):
                self.last_expr = self.enumerator.expr_str_of(
                    uid0 + len(is_const) - 1)
            return
        if self.native_sink is not None:
            emit = ~passing
            if not store_const:
                emit &= ~is_const
            locs = np.nonzero(emit)[0]
            n_new = len(is_const)
            if exprs:
                self.last_expr = exprs[-1]
            elif n_new:
                self.last_expr = self.enumerator.arena.get(uid0 + n_new - 1)
            if locs.size:
                if exprs is None:
                    blob = self.enumerator.arena.blob(
                        uid0 + locs.astype(np.int64))
                else:
                    blob = ("\x00".join([exprs[i] for i in locs.tolist()])
                            .encode() + b"\x00")
                sel = new_idx[locs]
                reason_code = np.where(
                    is_const[locs], 0,
                    np.where(nonfin[locs], 1, 2)).astype(np.uint8)
                enum = self.enumerator
                self.native_sink.emit(
                    ids=(uid0 + 1 + self.id_offset) + locs.astype(np.int64),
                    exprs_blob=blob, sigs=keys[locs], depth=depth,
                    reason_code=reason_code, rel=sr.rel_max[sel],
                    struct_op=int(enum.u_op[uid0]),
                    struct_a=enum.u_a[uid0 + locs],
                    struct_b=enum.u_b[uid0 + locs],
                    screen_ok=sr.screen_ok[sel], nonfinite=sr.nonfinite[sel],
                    is_const=sr.is_const[sel], fp_finite=sr.fp_finite[sel],
                    n_screen_points=len(self.problem.screen_points),
                    math_def=self._math_def.encode())
                self.n_rows += int(locs.size)
            return
        nsp = len(self.problem.screen_points)
        enum = self.enumerator
        s_op = int(enum.u_op[uid0]) if len(is_const) else -1
        s_a = enum.u_a[uid0:uid0 + len(is_const)].tolist()
        s_b = enum.u_b[uid0:uid0 + len(is_const)].tolist()
        rel_l = sr.rel_max[new_idx].tolist()
        ok_l = sr.screen_ok[new_idx].tolist()
        raw_nf_l = sr.nonfinite[new_idx].tolist()
        raw_c_l = sr.is_const[new_idx].tolist()
        fpf_l = sr.fp_finite[new_idx].tolist()
        const_l = is_const.tolist()
        nonfin_l = nonfin.tolist()
        pass_l = passing.tolist()
        keys_l = keys.tolist()
        n_emitted = 0
        as_tuples = on_rows is not None
        sink: List = []
        id0 = uid0 + 1 + self.id_offset
        for local in range(len(exprs)):
            if pass_l[local]:
                continue
            if const_l[local]:
                if not store_const:
                    continue
                reason = self._R_CONST
            elif nonfin_l[local]:
                reason = self._R_NONFIN
            else:
                reason = ("PDE residual != 0 (screen relres ≈ %.2e)"
                          % rel_l[local])
            ev = self._EV_FMT % (
                self._fmt_rel(rel_l[local]),
                "true" if ok_l[local] else "false",
                "true" if raw_nf_l[local] else "false",
                "true" if raw_c_l[local] else "false",
                "true" if fpf_l[local] else "false",
                nsp)
            e = exprs[local]
            sig = "%016x" % keys_l[local]
            n_emitted += 1
            sa = s_a[local]
            sb = s_b[local]
            if as_tuples:
                # column order must match RunDB.flush's INSERT
                sink.append((id0 + local, e, None, sig, depth, "completed",
                             0, reason, "screen", None, ev, 0, None, None,
                             None, None if s_op < 0 else s_op,
                             None if sa < 0 else sa,
                             None if sb < 0 else sb))
            else:
                row = Row(
                    id=id0 + local, expression=e, normalized=None,
                    signature=sig, depth=depth, is_valid=False,
                    validation_reason=reason, validator_method="screen",
                    validator_math=None, validator_evidence=ev,
                    struct_op=None if s_op < 0 else s_op,
                    struct_a=None if sa < 0 else sa,
                    struct_b=None if sb < 0 else sb)
                if self._keep_rows:
                    self.rows.append(row)
                if on_row is not None:
                    on_row(row)
        self.n_rows += n_emitted
        if exprs:
            self.last_expr = exprs[-1]
        if as_tuples and sink:
            on_rows(sink)

    def _verdict(self, cand: Candidate, ev, depth: int, st: DepthStats,
                 on_row=None, key: int = 0):
        if ev["is_const"] or not cand.has_var:
            if self.config.store_constants:
                self._add_row(cand, depth, False, self._R_CONST,
                              "screen", ev, on_row, key=key)
            return
        if not ev["fp_finite"] or ev["nonfinite"]:
            self._add_row(cand, depth, False, self._R_NONFIN,
                          "screen", ev, on_row, key=key)
            return
        if not ev["screen_ok"]:
            self._add_row(
                cand, depth, False,
                f"PDE residual != 0 (screen relres ≈ {ev['rel_max']:.2e})",
                "screen", ev, on_row, key=key)
            return
        if ev["rel_max"] < self.config.f64_skip_below:
            self._finalize_pass(cand, ev, ev["rel_max"], "screen",
                                depth, st, on_row, key)
        else:
            self._gray.append((cand, ev, key))

    @spans.traced("finalize")
    def _finalize_pass(self, cand, ev, rel64, f64_tag, depth, st, on_row,
                       key: int = 0):
        """Stages 3-4 for a candidate that survived the numeric funnel."""
        verdict, method = self._confirm_symbolic(cand)
        if verdict is False:
            self._add_row(
                cand, depth, False,
                "Invalid (symbolic residual != 0; numeric zero was "
                f"relres ≈ {rel64:.2e})",
                "screen+f64+symbolic", ev, on_row, key=key)
            return
        if verdict is True:
            reason = "Valid (exact zero; heavy checks deferred)"
        else:
            reason = (f"Valid (numeric zero, relres ≈ {rel64:.2e}; "
                      "symbolic confirm skipped)")
        with spans.span("match_known"):
            known = self._match_known(cand, ev["fp_vals"])
        row = self._add_row(cand, depth, True, reason,
                            f"{f64_tag}+{method}", ev, None, known=known,
                            key=key, rel64=rel64)
        st.valid += 1
        if not self.config.defer_heavy_checks:
            try:
                with spans.span("heavy_checks"):
                    hu = self.problem.tape_to_sympy(cand.tape)
                    h_ok, h_reason = self.problem.heavy_checks(hu)
            except Exception as e:
                h_ok, h_reason = False, f"heavy check error: {e}"
                self.errors += 1
            row.heavy_is_valid = h_ok
            row.heavy_reason = h_reason
            if not h_ok:
                row.is_valid = False
                row.validation_reason = h_reason
                st.valid -= 1
                self.valid_rows.remove(row)
        if on_row is not None:
            on_row(row)

    @spans.traced("gray.numeric")
    def _gray_numeric(self, part):
        """The float64 numeric section of the gray recheck for one chunk —
        a pure function of the candidates, run on the overlap thread."""
        consts = self.problem.consts.as_array(np.float64)
        pts = self.problem.screen_points
        uids = np.array([c.uid for c, _, _ in part], np.int64)
        tapes, lengths = self.enumerator.tapes_batch(uids)
        jets = eval_jets_np_many(tapes, lengths, consts, pts,
                                 self.problem.residual_order)
        res, scale = self.problem.residual_fn(jets, pts, np)
        with np.errstate(invalid="ignore"):
            rel = np.abs(res) / (scale + 1e-300)
        ok_pt = ((np.isfinite(res) & np.isfinite(scale))
                 & informative_points(res, scale, jets))
        finite = ((np.isfinite(res) & np.isfinite(scale)).all(axis=-1)
                  & ok_pt.any(axis=-1))
        rel = np.where(ok_pt, rel, 0.0)
        const64 = _const_in_f64_batch(jets)
        relmax = np.where(finite, rel.max(axis=-1), np.inf)
        return const64, finite, relmax

    def _gray_maybe_submit(self, chunk: int = 4096, depth: int = None,
                           st: DepthStats = None, on_row=None):
        """Stream gray chunks to the overlap worker during the depth and
        emit the finished ones on this thread (sqlite and Row bookkeeping
        are not thread-safe)."""
        while len(self._gray) >= chunk:
            part = self._gray[:chunk]
            del self._gray[:chunk]
            self._gray_done.append(
                (part, self._gray_pool.submit(self._gray_numeric, part)))
        if st is not None:
            while self._gray_done and self._gray_done[0][1].done():
                part, fut = self._gray_done.pop(0)
                with spans.span("gray.wait"):
                    res = fut.result()
                self._emit_gray_part(part, res, depth, st, on_row)

    @spans.traced("gray.emit")
    def _emit_gray_part(self, part, res, depth, st, on_row):
        const64, finite, relmax = res
        for j, (cand, ev, key) in enumerate(part):
            if const64[j]:
                self._add_row(cand, depth, False, self._R_CONST,
                              "screen+f64", ev, on_row, key=key)
            elif finite[j] and relmax[j] < self.confirm_rtol:
                self._finalize_pass(cand, ev, float(relmax[j]),
                                    "screen+f64", depth, st, on_row,
                                    key)
            else:
                self._add_row(
                    cand, depth, False,
                    f"Invalid (f64 recheck relres ≈ {relmax[j]:.2e})",
                    "screen+f64", ev, on_row, key=key)

    def _flush_gray(self, depth: int, st: DepthStats, on_row=None,
                    chunk: int = 4096):
        """Drain the gray zone in submission order."""
        if self._gray:
            for i in range(0, len(self._gray), chunk):
                part = self._gray[i:i + chunk]
                self._gray_done.append(
                    (part, self._gray_pool.submit(self._gray_numeric,
                                                  part)))
            self._gray = []
        done, self._gray_done = self._gray_done, []
        for part, fut in done:
            with spans.span("gray.wait"):
                res = fut.result()
            self._emit_gray_part(part, res, depth, st, on_row)

    def _add_row(self, cand, depth, is_valid, reason, method, ev,
                 on_row=None, known=None, key: int = 0,
                 rel64: Optional[float] = None) -> Optional[Row]:
        if not is_valid and not self.config.audit_rejects:
            self.n_rows += 1
            self.last_expr = cand.expr_str
            return None
        if key:
            sig = f"{key:016x}"
        elif ev["fp_finite"]:
            sig = f"{((ev['fp'][0] << 32) | ev['fp'][1]) & FP_MASK:016x}"
        else:
            sig = f"{struct_key_for_expr(cand.expr_str):016x}"
        evidence = (
            '{"rel_max": %s, "screen_ok": %s, "nonfinite": %s,'
            ' "is_const": %s, "fp_finite": %s, "n_screen_points": %d,'
            ' "stage": "%s"%s}' % (
                self._fmt_rel(ev["rel_max"]),
                "true" if ev["screen_ok"] else "false",
                "true" if ev["nonfinite"] else "false",
                "true" if ev["is_const"] else "false",
                "true" if ev["fp_finite"] else "false",
                len(self.problem.screen_points), method,
                "" if rel64 is None
                else ', "rel_f64": %s' % self._fmt_rel(rel64)))
        uid = cand.uid
        s_op = int(self.enumerator.u_op[uid])
        s_a = int(self.enumerator.u_a[uid])
        s_b = int(self.enumerator.u_b[uid])
        row = Row(
            id=cand.uid + 1 + self.id_offset,
            expression=cand.expr_str,
            normalized=cand.expr_str if is_valid else None,
            signature=sig,
            depth=depth,
            is_valid=is_valid,
            validation_reason=reason,
            validator_method=method,
            is_paper_solution=known is not None,
            paper_solution_name=known,
            validator_math=self._math_def if is_valid else None,
            validator_evidence=evidence,
            struct_op=None if s_op < 0 else s_op,
            struct_a=None if s_a < 0 else s_a,
            struct_b=None if s_b < 0 else s_b,
        )
        self.n_rows += 1
        self.last_expr = cand.expr_str
        if self._keep_rows:
            self.rows.append(row)
        if is_valid:
            self.valid_rows.append(row)
        if on_row is not None:
            on_row(row)
        return row

    # ------------------------------------------------------------------
    # Per-op path (use_segmented=False)
    # ------------------------------------------------------------------

    def _use_segmented(self) -> bool:
        return self.mesh is None and self.config.use_segmented is not False

    def _op_call(self, op_name: str):
        """The mesh call of ``op_name`` (JAX ``_op_kernel`` on a mesh):
        across processes the all-gathering one, on a uid-range-sharded
        cache the uid-range one, else the replicated one."""
        from .parallel import distributed, incremental
        kw = dict(order=self.problem.residual_order,
                  residual_key=self.problem.get_residual_key(),
                  screen_rtol=float(self.screen_rtol),
                  n_screen=len(self.problem.screen_points),
                  n_fp=len(self.problem.fingerprint_points))
        if self._multihost:
            return distributed.make_op_kernel_multihost(self.mesh, op_name,
                                                        **kw)
        if self._cache_sharded:
            return incremental.make_op_kernel_uidrange(self.mesh, op_name,
                                                       **kw)
        return incremental.make_op_kernel_sharded(self.mesh, op_name, **kw)

    def _local_rows(self, n: int) -> int:
        """Rows of an ``n``-candidate batch that this process launches:
        all of them, or its shard across processes."""
        if not self._multihost:
            return n
        from .parallel.distributed import process_count, process_index
        lo, hi = shard_ranges(n, process_count())[process_index()]
        return hi - lo

    def _tally_launch(self, kind: str, rows: int, sizes) -> None:
        tally_launch(self.launch_rows[kind], rows, sizes)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

    def _eval_op_idx(self, op_name: str, a_idx: np.ndarray,
                     b_idx: Optional[np.ndarray]):
        """One ``universal`` launch: op ``op_name`` over the operand rows
        ``(a_idx[i], b_idx[i])``, exactly ``n`` rows (a unary op's b rows
        read row 0 and are not used).  The JAX package pads the launch to
        8,192 rows or ``batch_size`` to keep its jit traces to two shapes
        per op; the CUDA kernel has no trace cache and masks its own
        ragged edge, so every result here has ``n`` rows.  On a mesh the
        batch goes through :meth:`_op_call`, one launch per non-empty
        shard, and ``mesh_survivors`` holds its summed survivor count."""
        n = a_idx.size
        ab = np.zeros((n, 2), np.int32)
        ab[:, 0] = a_idx
        if b_idx is not None:
            ab[:, 1] = b_idx
        t0 = time.perf_counter()
        if self.mesh is not None:
            packed, out_s, out_f, self.mesh_survivors = self._op_call(
                op_name)(self.cache, torch.from_numpy(ab), self._spoints,
                         self._fpoints)
        else:
            packed, out_s, out_f = cuda_engine.universal(
                self._spec, self.cache.screen, self.cache.fp, self._dev(ab),
                OP_INDEX[op_name], self._spoints, self._fpoints)
        self.device_seconds += time.perf_counter() - t0
        self.candidates_screened += n
        self.universal_dispatches += 1
        rows = self._local_rows(n)
        self._tally_launch("universal", rows, [rows])
        if self._multihost:
            self.shard_launches += int(rows > 0)
        elif self.mesh is not None:
            self.shard_launches += sum(hi > lo
                                       for lo, hi in self.mesh.split(n))
        return packed, out_s, out_f

    def _run_depth_per_op(self, depth: int, max_depth: int,
                          st: DepthStats, on_row, on_rows, on_batch):
        """One launch per op batch of the enumerator, software-pipelined:
        batch k+1 is launched before batch k is drained.  Safe: depth-d
        candidates read only cache rows of depths < d, and the rows
        appended during depth d are never read within it."""
        gen = self.enumerator.vector_batches_at_depth(
            depth, self.config.batch_size, max_parent_uid=self.cache.n)
        pending = None

        def drain(item, state):
            op_name, a_u, b_u, packed, out_s, out_f = item
            with spans.span("device"):
                ti = time.perf_counter()
                sr = self._unpack_finish(*state)
                st.t_device += time.perf_counter() - ti
                self.device_seconds += time.perf_counter() - ti
            with spans.span("ingest"):
                ti = time.perf_counter()
                self._ingest_vec(
                    op_name, a_u, b_u, sr, depth, st, on_row, out_s, out_f,
                    append_cache=(depth < max_depth or self.cache.n
                                  < self.config.final_append_limit),
                    on_rows=on_rows, retain_strings=(depth < max_depth))
                st.t_ingest += time.perf_counter() - ti
            self._gray_maybe_submit(depth=depth, st=st, on_row=on_row)
            if on_batch is not None:
                on_batch(st)

        def head(item):
            """Fetch the verdicts and gather the passer rows of ``item``;
            runs before the next launch."""
            with spans.span("device"):
                th = time.perf_counter()
                state = self._unpack_start(item[3], item[5])
                st.t_device += time.perf_counter() - th
                self.device_seconds += time.perf_counter() - th
            return state

        while True:
            with spans.span("enum"):
                te = time.perf_counter()
                item = next(gen, None)
                st.t_enum += time.perf_counter() - te
            if item is None:
                break
            op_name, a_u, b_u = item
            if a_u.size == 0:
                continue
            state = head(pending) if pending is not None else None
            with spans.span("device"):
                td = time.perf_counter()
                packed, out_s, out_f = self._eval_op_idx(op_name, a_u, b_u)
                st.t_device += time.perf_counter() - td
            if pending is not None:
                drain(pending, state)
            pending = (op_name, a_u, b_u, packed, out_s, out_f)
        if pending is not None:
            drain(pending, head(pending))

    # ------------------------------------------------------------------
    # Segmented superbatch path
    # ------------------------------------------------------------------

    def _run_depth_segmented(self, depth: int, max_depth: int,
                             st: DepthStats, on_row, on_rows, on_batch):
        """The depth's candidates in the launches of
        :func:`route_segmented`: mixed-op superbatches (segmented) and
        the two gather-bypass kinds for run-shaped blocks (structured,
        tiled), software-pipelined: launch k+1 goes out before launch k
        is drained."""
        SUPER = max(TILE, (self.config.batch_size // TILE) * TILE)

        def append_ok():
            return (depth < max_depth
                    or self.cache.n < self.config.final_append_limit)

        def launch(ln: Launch):
            with spans.span("device"):
                td = time.perf_counter()
                packed, out_s, out_f = launch_screen(
                    self._spec, self.cache, ln,
                    tuple(self._dev(x) for x in ln.index), self._spoints,
                    self._fpoints)
                st.t_device += time.perf_counter() - td
            name = f"{ln.kernel}_dispatches"
            setattr(self, name, getattr(self, name) + 1)
            self._tally_launch(ln.kernel, ln.rows,
                               [s[2].size for s in ln.segs])
            return (ln.segs, packed, out_s, out_f)

        def drain_head(item):
            """Fetch verdicts + gather the passer rows.  Runs before the
            next launch."""
            _, packed, _, out_f = item
            with spans.span("device"):
                ti = time.perf_counter()
                state = self._unpack_start(packed, out_f)
                st.t_device += time.perf_counter() - ti
                self.device_seconds += time.perf_counter() - ti
            return state

        def drain_tail(item, state):
            d_segs, packed, out_s, out_f = item
            self.candidates_screened += sum(s[2].size for s in d_segs)
            with spans.span("device"):
                ti = time.perf_counter()
                sr = self._unpack_finish(*state)
                st.t_device += time.perf_counter() - ti
                self.device_seconds += time.perf_counter() - ti
            with spans.span("ingest"):
                ti = time.perf_counter()
                kept: List[int] = []
                for (op_name, start, a_seg, b_seg) in d_segs:
                    n = a_seg.size
                    view = ScreenResult(*[f[start:start + n] for f in sr])
                    self._ingest_vec(
                        op_name, a_seg, b_seg, view, depth, st, on_row,
                        out_s, out_f, append_cache=append_ok(),
                        on_rows=on_rows,
                        retain_strings=(depth < max_depth),
                        row_offset=start, defer_append_to=kept)
                if kept and append_ok():
                    room = self.cache_row_limit - self.cache.n
                    if room > 0:
                        self._append_kept(out_s, out_f, kept[:room])
                st.t_ingest += time.perf_counter() - ti
            self._gray_maybe_submit(depth=depth, st=st, on_row=on_row)
            if on_batch is not None:
                on_batch(st)

        def timed(gen):
            while True:
                with spans.span("enum"):
                    te = time.perf_counter()
                    item = next(gen, None)
                    st.t_enum += time.perf_counter() - te
                if item is None:
                    return
                yield item

        batches = timed(self.enumerator.vector_batches_at_depth(
            depth, SUPER, max_parent_uid=self.cache.n))
        pending = None
        for ln in route_segmented(
                batches, SUPER, self.config.tiled_min_rows,
                lambda: self.cache.capacity,
                structured=self.config.use_structured is not False,
                tiled=self.config.use_tiled is not False):
            state = drain_head(pending) if pending is not None else None
            item = launch(ln)
            if pending is not None:
                drain_tail(pending, state)
            pending = item
        if pending is not None:
            drain_tail(pending, drain_head(pending))

    def _run_depth_tape(self, depth: int, st: DepthStats, on_row=None):
        """The tape engine's depth (the JAX engine's ``engine="tape"``
        branch): the depth's candidates from
        ``Enumerator.candidates_at_depth``, ``batch_size`` of them a flush,
        each evaluated from its whole tape by the float64 oracle
        (``_eval_tape_groups``) and ingested one by one (``_ingest``);
        their jets land on the engine's device as cache rows.  ``t_enum``
        times the candidates' generation and ``t_ingest`` the ingest; the
        oracle's time is the stage's rest."""
        buf: List[Candidate] = []

        def flush(buf):
            for group, evals, out_s, out_f in self._eval_tape_groups(buf):
                with spans.span("ingest"):
                    ti = time.perf_counter()
                    self._ingest(group, evals, depth, st, on_row, out_s,
                                 out_f)
                    st.t_ingest += time.perf_counter() - ti

        gen = self.enumerator.candidates_at_depth(depth)
        while True:
            with spans.span("enum"):
                te = time.perf_counter()
                cand = next(gen, None)
                st.t_enum += time.perf_counter() - te
            if cand is None:
                break
            buf.append(cand)
            if len(buf) >= self.config.batch_size:
                flush(buf)
                buf = []
        if buf:
            flush(buf)

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def run(self, max_depth: Optional[int] = None, on_row=None,
            on_depth=None, start_depth: int = 1, on_batch=None,
            on_rows=None) -> List[DepthStats]:
        max_depth = max_depth or self.config.max_depth
        self._keep_rows = on_rows is None
        for depth in range(start_depth, max_depth + 1):
            if depth > start_depth:
                # what ended after the depth before: its barrier
                spans.drain(self.stats[-1])
            with spans.span("depth"):
                t0 = time.perf_counter()
                st = DepthStats(depth=depth)
                self._run_depth(depth, max_depth, st, on_row, on_rows,
                                on_batch)
                with spans.span("gray.flush"):
                    tg = time.perf_counter()
                    self._flush_gray(depth, st, on_row)
                    st.t_gray = time.perf_counter() - tg
                st.seconds = time.perf_counter() - t0
            # the depth's spans, and those that ended before the run's
            # first depth
            spans.drain(st)
            self.stats.append(st)
            if on_depth is not None:
                on_depth(st)
        return self.stats

    def _run_depth(self, depth: int, max_depth: int, st: DepthStats,
                   on_row, on_rows, on_batch):
        """One depth's candidates through its path, up to the depth-end
        flush of the gray rows."""
        if depth == 1:
            prims = self.enumerator.primitive_candidates()
            for group, evals, out_s, out_f in self._eval_tape_groups(prims):
                self._ingest(group, evals, depth, st, on_row, out_s, out_f)
        elif self.config.engine == "tape":
            self._run_depth_tape(depth, st, on_row)
        else:
            if self.cache.n < self.enumerator.count_uniques():
                trunc = self.enumerator.count_uniques() - self.cache.n
                fix = ("raise --max-cache-rows or add devices"
                       if self._cache_sharded else
                       "raise --max-cache-rows, or split the cache "
                       "over a mesh with --devices K --shard-cache")
                print(f"  [mem] parent window truncated: {trunc} of "
                      f"{self.enumerator.count_uniques()} uniques "
                      "exceed the cache budget and are not composed "
                      f"deeper ({fix})", flush=True)
            run_depth = (self._run_depth_segmented
                         if self._use_segmented()
                         else self._run_depth_per_op)
            run_depth(depth, max_depth, st, on_row, on_rows, on_batch)

    def dispatch_counts(self) -> Dict[str, int]:
        return {"segmented": self.segmented_dispatches,
                "structured": self.structured_dispatches,
                "tiled": self.tiled_dispatches,
                "universal": self.universal_dispatches}

    def launched_rows(self) -> Dict[str, Dict[str, int]]:
        """Per kernel: the rows its launches screened, the candidates
        among them, and the rows of the 512-row tiles that hold a
        candidate.  ``segmented`` and ``universal`` launch exactly their
        candidates, and ``tiled`` exactly those tiles."""
        return launched_rows_of(self.launch_rows)

    def summary(self) -> Dict:
        """The run so far, with the JAX engine's ``summary()`` keys: each
        depth's stats holds the JAX ``DepthStats`` fields (the ``TRACED``
        ones stay in ``self.stats``); ``candidates_screened`` counts the
        candidates screened, by the float64 oracle at depth 1 (and on the
        tape engine) and by the kernels after it, and no pad row."""
        return {
            "problem": self.problem.slug,
            "depths": [{k: v for k, v in vars(s).items()
                        if k not in TRACED} for s in self.stats],
            "total_candidates": sum(s.candidates for s in self.stats),
            "total_unique": sum(s.unique for s in self.stats),
            "total_valid": len(self.valid_rows),
            "paper_solutions": sorted({r.paper_solution_name
                                       for r in self.valid_rows
                                       if r.paper_solution_name}),
            "device_seconds": self.device_seconds,
            "candidates_screened": self.candidates_screened,
        }

    # ------------------------------------------------------------------
    # Resume: cache seeding
    # ------------------------------------------------------------------

    def seed_cache_from_uniques(self, snapshot: Optional[dict] = None,
                                limit: Optional[int] = None):
        """Restore the jet cache for the reloaded uniques ``[0, total)``,
        ``total`` capped at ``limit`` (the parent window to restore).

        A ``snapshot`` (the run's jet shards) restores its rows bit for
        bit.  The rows past it are rebuilt as a fresh run built them:
        depth-1 leaves through the float64 oracle first, then every
        composed row by replaying its (op, a, b) triple through the
        production kernels, depth by depth, so that each replayed row
        reads parents that are already seeded.  (The JAX package replays
        composed rows before it seeds the leaves, so without a snapshot
        its replay reads unseeded parent rows.)"""
        total = self.enumerator.count_uniques()
        if limit is not None:
            total = min(total, limit)
        if total == 0:
            return
        n0 = 0
        if snapshot is not None:
            n0 = min(int(snapshot["n"]), total)
            if n0:
                # snapping is idempotent on rows this code wrote and puts
                # older sidecars' rows back on the grid
                self.cache.load_rows(
                    snapshot["screen"][:n0],
                    snap_fp_jets_np(np.asarray(snapshot["fp"][:n0],
                                               np.float32)))
        if n0 < total:
            if total > self.cache.capacity:
                self.cache._grow(total)
            counters = (self.candidates_screened, self.segmented_dispatches,
                        self.universal_dispatches, self.shard_launches,
                        {k: list(v) for k, v in self.launch_rows.items()})
            self._seed_leaf_rows(n0, total)
            self._replay_composed_rows(n0, total)
            # seeding is not screening work: the run's counters stay its own
            (self.candidates_screened, self.segmented_dispatches,
             self.universal_dispatches, self.shard_launches,
             self.launch_rows) = counters
        self.cache.n = max(self.cache.n, total)

    def _scatter_rows(self, uids: np.ndarray, out_s, out_f):
        self.cache.scatter(uids, out_s, out_f)

    def _seed_leaf_rows(self, lo: int, total: int):
        """Cache rows ``[lo, total)`` of the leaves (uniques without a
        structural triple: the depth-1 primitives) through the float64
        oracle, as a fresh run's depth 1 does."""
        enum = self.enumerator
        idx = np.arange(lo, total, dtype=np.int64)
        leaves = idx[np.asarray(enum.u_op[lo:total]) < 0]
        if leaves.size == 0:
            return
        uniques = [enum.unique_at(int(i)) for i in leaves]
        for group, _, out_s, out_f in self._eval_tape_groups(uniques):
            self._scatter_rows(np.array([u.uid for u in group]), out_s,
                               out_f)

    def _replay_composed_rows(self, lo: int, total: int):
        """Cache rows ``[lo, total)`` of the composed uniques: replay their
        (op, a, b) triples through the production kernels, depth-ascending
        (a unique's parents live at strictly lower depths).  The per-op
        path replays each (depth, op) run through ``universal``; the
        segmented path replays each depth's rows, op runs back to back,
        through ``segmented`` in launches of at most a superbatch."""
        enum = self.enumerator
        idx = np.arange(lo, total, dtype=np.int64)
        composed = idx[np.asarray(enum.u_op[lo:total]) >= 0]
        if composed.size == 0:
            return
        # surface-op id -> kernel op id (OP_INDEX), via the name table
        op_lut = np.asarray([OP_INDEX.get(n, -1) for n in enum._op_names],
                            np.int32)
        depths = np.asarray(enum.u_depth[composed])
        kops = op_lut[np.asarray(enum.u_op[composed])]
        if int(kops.min()) < 0:
            raise ValueError("unknown surface op in replay")
        order = np.lexsort((composed, kops, depths))
        composed, depths, kops = (composed[order], depths[order],
                                  kops[order])
        a_all = np.asarray(enum.u_a[composed], np.int32)
        b_all = np.asarray(enum.u_b[composed], np.int32)
        b_all = np.where(b_all < 0, 0, b_all)
        SUPER = max(TILE, (self.config.batch_size // TILE) * TILE)
        pos, n = 0, composed.size
        while pos < n:
            # one depth at a time: a launch never holds a child of a row
            # it also writes
            dend = pos + int(np.searchsorted(depths[pos:], depths[pos],
                                             "right"))
            dp = pos
            if not self._use_segmented():
                while dp < dend:
                    oend = dp + int(np.searchsorted(kops[dp:dend], kops[dp],
                                                    "right"))
                    _, out_s, out_f = self._eval_op_idx(
                        OP_ORDER[int(kops[dp])], a_all[dp:oend],
                        b_all[dp:oend])
                    self._scatter_rows(composed[dp:oend], out_s, out_f)
                    dp = oend
                pos = dend
                continue
            for lo_r in range(pos, dend, SUPER):
                hi_r = min(lo_r + SUPER, dend)
                ab = np.stack([a_all[lo_r:hi_r], b_all[lo_r:hi_r]], axis=1)
                t0 = time.perf_counter()
                _, out_s, out_f = cuda_engine.segmented(
                    self._spec, self.cache.screen, self.cache.fp,
                    self._dev(ab), self._dev(kops[lo_r:hi_r]),
                    self._spoints, self._fpoints)
                self.segmented_dispatches += 1
                self._scatter_rows(composed[lo_r:hi_r], out_s, out_f)
                self.device_seconds += time.perf_counter() - t0
            pos = dend


def cuda_emit_spec(problem, screen_rtol: float) -> cuda_engine.ScreenSpec:
    """The screen-kernel spec of a problem (its residual key registered)."""
    return cuda_engine.ScreenSpec(
        order=problem.residual_order, residual_key=problem.get_residual_key(),
        screen_rtol=float(screen_rtol),
        n_screen=len(problem.screen_points),
        n_fp=len(problem.fingerprint_points))
