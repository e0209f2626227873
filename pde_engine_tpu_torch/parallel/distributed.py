"""Multi-process runs on ``torch.distributed``: one process per device.

Counterpart of ``pde_engine_tpu/parallel/distributed.py``.  The JAX
package runs one process per host over a global mesh of every chip of
every host; the port runs one process per device, PyTorch's idiom
(ROADMAP §3).  The rest is the JAX package's design:

- each process calls :func:`initialize` (explicit arguments, else the
  ``PDE_ENGINE_NUM_PROCESSES`` / ``PDE_ENGINE_COORDINATOR`` /
  ``PDE_ENGINE_PROCESS_ID`` variables, else torchrun's ``WORLD_SIZE`` /
  ``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``); one process is a no-op;
- every process runs the SAME enumeration, screens its contiguous shard
  of each batch with the hand ``universal`` kernel on its device, and
  all-gathers the packed verdicts and the jets
  (:func:`make_op_kernel_multihost`), so that every process ingests the
  same rows and appends the same cache rows: the depth barrier is the
  only synchronisation besides the exchange;
- only rank 0 writes the run DB, the reports and the sidecars
  (:func:`is_writer`); ``SearchConfig.shard_registry`` splits the dedup
  map by key mod the process count (:func:`registry_shard`,
  :func:`or_reduce_mask`).

The backend is chosen before ``init_process_group`` and never switched:
NCCL when each process has a card of its own, gloo on the CPU and when
processes share a card (NCCL refuses two ranks on one card).  Under
gloo the exchange is staged through host buffers; under NCCL it runs on
the device.  A process group that does not form, or a rank that fails,
ends the run: nothing carries on alone or on the CPU.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta
from typing import Optional

import numpy as np
import torch

from .mesh import CandidateMesh, candidate_mesh, shard_ranges

# seconds a collective (and the group's rendezvous) may wait for the
# other ranks before the run fails
TIMEOUT_S = 600

_STATE = {"backend": None, "device": None}

# the verdict and jet exchange of make_op_kernel_multihost: calls,
# seconds and bytes gathered (rows of all ranks), for the stage lines
EXCHANGE = {"calls": 0, "seconds": 0.0, "bytes": 0}


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _resolve(coordinator_address, num_processes, process_id):
    """(coordinator "host:port" or None, world, rank) in the order:
    explicit arguments, PDE_ENGINE_* variables, torchrun's variables."""
    if num_processes is None:
        num_processes = _env_int("PDE_ENGINE_NUM_PROCESSES")
    coordinator_address = (coordinator_address
                           or os.environ.get("PDE_ENGINE_COORDINATOR"))
    if process_id is None:
        process_id = _env_int("PDE_ENGINE_PROCESS_ID")
    if num_processes is None and _env_int("WORLD_SIZE") is not None:
        num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
        if coordinator_address is None and os.environ.get("MASTER_ADDR"):
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
    return coordinator_address, int(num_processes or 1), process_id


def choose_backend(device: str, local_world: int, local_rank: int,
                   n_cards: int):
    """(backend, torch.device of this process, why): NCCL when every
    local process has a card of its own, else gloo (the CPU, or
    processes that share a card)."""
    if torch.device(device).type == "cpu":
        return "gloo", torch.device("cpu"), "cpu processes"
    if n_cards < 1:
        raise RuntimeError("device 'cuda' requested but this host has no "
                           "usable card")
    if n_cards >= local_world:
        return ("nccl", torch.device("cuda", local_rank),
                f"one card per process, {local_world} on this host")
    return ("gloo", torch.device("cuda", local_rank % n_cards),
            f"{local_world} processes share {n_cards} "
            f"card{'s' if n_cards != 1 else ''}")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> bool:
    """Join the process group; True if the run is distributed.  One
    process is a no-op (so every path may call this).  Prints the rank,
    the backend and the device on one line.  ``LOCAL_WORLD_SIZE`` and
    ``LOCAL_RANK`` (torchrun sets them) say how many processes share
    this host; without them every process is taken to be local."""
    import torch.distributed as dist
    coord, world, rank = _resolve(coordinator_address, num_processes,
                                  process_id)
    if world <= 1:
        return False
    if rank is None or not 0 <= rank < world:
        raise ValueError(f"process id {rank} of {world} processes: set "
                         "PDE_ENGINE_PROCESS_ID (or RANK)")
    if not coord:
        raise ValueError("a multi-process run needs a coordinator "
                         "host:port (PDE_ENGINE_COORDINATOR or "
                         "MASTER_ADDR/MASTER_PORT)")
    local_world = _env_int("LOCAL_WORLD_SIZE") or world
    local_rank = _env_int("LOCAL_RANK")
    if local_rank is None:
        local_rank = rank % local_world
    n_cards = (torch.cuda.device_count()
               if torch.device(device).type == "cuda"
               and torch.cuda.is_available() else 0)
    backend, dev, why = choose_backend(device, local_world, local_rank,
                                       n_cards)
    print(f"distributed: rank {rank} of {world}, backend {backend} ({why}), "
          f"device {dev}, coordinator {coord}", flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=TIMEOUT_S))
    _STATE.update(backend=backend, device=dev)
    return True


def _group():
    import torch.distributed as dist
    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _group()
    return d.get_rank() if d is not None else 0


def process_count() -> int:
    d = _group()
    return d.get_world_size() if d is not None else 1


def backend() -> Optional[str]:
    return _STATE["backend"] if _group() is not None else None


def is_writer() -> bool:
    """Single-writer discipline: only rank 0 owns the run DB."""
    return process_index() == 0


def registry_shard() -> tuple:
    """(rank, world) for registry sharding: this process owns the dedup
    keys with ``key % world == rank``.  (0, 1) when not distributed."""
    return process_index(), process_count()


def or_reduce_mask(mask: np.ndarray) -> np.ndarray:
    """Element-wise OR of a boolean mask across the processes (one uint8
    MAX all-reduce, on the device under NCCL).  Ownership partitions the
    positions that the sharded-registry dedup marks, so the OR is a
    disjoint union and every process gets the same first-occurrence
    mask."""
    d = _group()
    if d is None or d.get_world_size() <= 1:
        return mask
    t = torch.from_numpy(mask.astype(np.uint8))
    if _STATE["backend"] == "nccl":
        t = t.to(_STATE["device"])
    d.all_reduce(t, op=d.ReduceOp.MAX)
    return t.cpu().numpy().astype(np.bool_)


def agree(value: str) -> str:
    """Rank 0's ``value`` on every rank (``value`` itself when not
    distributed): a fresh run's id, drawn on each rank from the clock and
    random bits, must be one id."""
    d = _group()
    if d is None:
        return value
    box = [value]
    d.broadcast_object_list(box, src=0)
    return box[0]


def barrier() -> None:
    """Wait for every process (no-op when not distributed): the resume's
    barrier, so that no process rebuilds before the writer has flushed
    the state of the run it resumes (JAX ``sync_global_devices``)."""
    d = _group()
    if d is not None:
        d.barrier()


def shutdown() -> None:
    """Leave the process group after a last barrier."""
    d = _group()
    if d is not None:
        d.barrier()
        d.destroy_process_group()
    _STATE.update(backend=None, device=None)


def global_candidate_mesh(device: str = "cuda") -> CandidateMesh:
    """This process's one device: the port runs one device per process,
    so the JAX package's global mesh is the process group.  Without a
    process group, a mesh of one device of ``device``'s type."""
    if _group() is not None and _STATE["device"] is not None:
        return CandidateMesh([_STATE["device"]])
    return candidate_mesh(1, device)


def all_gather_rows(tensors, sizes):
    """Each of ``tensors`` (4-byte types, ``[m_r, width]``, ``m_r =
    sizes[r]`` on rank ``r``) gathered from every rank and concatenated
    in rank order, on this rank's tensors' device.  The tensors travel
    packed in one int32 buffer padded to the largest shard; under gloo
    through host memory, under NCCL on the device."""
    import torch.distributed as dist
    dev = tensors[0].device
    widths = [int(t.shape[1]) for t in tensors]
    m = max(sizes)
    stage = dev if _STATE["backend"] == "nccl" else torch.device("cpu")
    buf = torch.zeros((m, sum(widths)), dtype=torch.int32, device=stage,
                      pin_memory=(stage.type == "cpu"
                                  and dev.type == "cuda"))
    col = 0
    for t, w in zip(tensors, widths):
        buf[:t.shape[0], col:col + w] = t.view(torch.int32)
        col += w
    parts = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(parts, buf)
    whole = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    if whole.device != dev:
        whole = whole.to(dev)
    out, col = [], 0
    for t, w in zip(tensors, widths):
        out.append(whole[:, col:col + w].contiguous().view(t.dtype))
        col += w
    return out


def make_op_kernel_multihost(mesh, op_name: str, order: int,
                             residual_key: str, screen_rtol: float,
                             n_screen: int, n_fp: int):
    """``call(cache, ab_idx, spoints, fpoints) -> (packed, jets, fj,
    survivors)`` over the whole batch on every rank: this rank screens
    its contiguous shard (``shard_ranges(n, world)[rank]``) with one
    ``universal`` launch on its device over its replica of the cache,
    then the packed verdicts, screen jets and fingerprint jets of every
    shard are all-gathered in rank order (JAX
    ``make_op_kernel_multihost``: 12 B of verdicts and 552 B of jets a
    force_free candidate).  ``EXCHANGE`` times the exchange."""
    from .cuda_engine import universal
    from .incremental import OP_INDEX, _spec
    spec = _spec(order, residual_key, screen_rtol, n_screen, n_fp)
    op_id = OP_INDEX[op_name]

    def call(cache, ab_idx, spoints, fpoints):
        rank, world = process_index(), process_count()
        sizes = [hi - lo for lo, hi in shard_ranges(int(ab_idx.shape[0]),
                                                    world)]
        lo = sum(sizes[:rank])
        dev = cache.device
        if sizes[rank]:
            local = universal(spec, cache.screen, cache.fp,
                              ab_idx[lo:lo + sizes[rank]].to(dev), op_id,
                              spoints, fpoints)
        else:
            local = (torch.empty((0, 3), dtype=torch.int32, device=dev),
                     torch.empty((0, spec.sdim), device=dev),
                     torch.empty((0, spec.fdim), device=dev))
        t0 = time.perf_counter()
        packed, jets, fj = all_gather_rows(local, sizes)
        EXCHANGE["calls"] += 1
        EXCHANGE["seconds"] += time.perf_counter() - t0
        EXCHANGE["bytes"] += sum(t.numel() * 4 for t in (packed, jets, fj))
        return packed, jets, fj, (packed[:, 2] & 1).sum()

    return call
