"""The candidate mesh: the devices one process shards a batch over.

Counterpart of ``pde_engine_tpu/parallel/mesh.py``.  The JAX package
shards the candidate axis of a batch over a 1-D ``jax.sharding.Mesh``
and lets ``shard_map`` place the shards.  Here a :class:`CandidateMesh`
is an explicit, ordered list of ``torch.device`` s, and the engine
splits each batch into contiguous shards itself
(:func:`shard_ranges`), shard ``k`` screened on ``devices[k]``.  A mesh
may repeat a device (two shards on one card, or ``cpu``) as the JAX
tests' virtual CPU devices do; :func:`candidate_mesh` takes the first
``n`` cards and refuses more than there are.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

CANDIDATE_AXIS = "candidates"


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_ranges(n: int, k: int) -> List[Tuple[int, int]]:
    """The ``k`` contiguous ranges ``[lo, hi)`` that split ``n`` rows in
    order, the first ``n % k`` one row longer than the rest."""
    base, extra = divmod(int(n), int(k))
    out, lo = [], 0
    for i in range(k):
        hi = lo + base + (i < extra)
        out.append((lo, hi))
        lo = hi
    return out


class CandidateMesh:
    """An ordered list of devices of one type (all ``cuda`` or all
    ``cpu``); shard ``k`` of a batch runs on ``devices[k]``, and
    ``devices[0]`` is the home device, where a batch's outputs are
    gathered."""

    def __init__(self, devices: Sequence):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a candidate mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a candidate mesh holds cuda devices or cpu "
                             f"devices, not {sorted(kinds)}")
        if "cuda" in kinds:
            if not torch.cuda.is_available():
                raise RuntimeError("a cuda mesh needs a GPU, and "
                                   "torch.cuda.is_available() is False")
            count = torch.cuda.device_count()
            devs = tuple(torch.device("cuda", d.index or 0) for d in devs)
            bad = [str(d) for d in devs if d.index >= count]
            if bad:
                raise ValueError(f"mesh devices {bad} are not among the "
                                 f"{count} cards of this host")
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def split(self, n: int) -> List[Tuple[int, int]]:
        return shard_ranges(n, self.size)

    def __repr__(self) -> str:
        return f"CandidateMesh({[str(d) for d in self.devices]})"


def candidate_mesh(n_devices: int = None, device="cuda") -> CandidateMesh:
    """A mesh of the first ``n_devices`` cards (all of them when None),
    or of ``n_devices`` CPU shards with ``device="cpu"``.  More cards than
    the host has are refused, never cut to what there is."""
    kind = torch.device(device).type
    if kind == "cpu":
        return CandidateMesh(["cpu"] * int(n_devices or 1))
    if kind != "cuda":
        raise ValueError(f"unsupported mesh device {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but "
                           "torch.cuda.is_available() is False")
    count = torch.cuda.device_count()
    n = count if n_devices is None else int(n_devices)
    if not 1 <= n <= count:
        raise ValueError(f"--devices {n}: this host has {count} "
                         f"card{'s' if count != 1 else ''}")
    return CandidateMesh([torch.device("cuda", i) for i in range(n)])
