"""The comparison that decides ``correct`` against its control and planted
faults (CPU, the laplace cell with heavy checks, at depths 3 and 4).

Each case skips the harness's look for a card and drives the rest of a
run (``benchmark.run.run_cell`` on the CPU: set-up, one run in the window,
the check) with the timed path broken underneath, and sees ``correct``
come out false; the sound run beside them comes out true.  The exchange
between chips has no fault here: every cell runs on one card.
"""

from __future__ import annotations

import copy

import numpy as np
import pytest

import benchmark.run as harness
from benchmark.harness import spec
from pde_engine_tpu_torch import pipeline
from pde_engine_tpu_torch.enumerator import Enumerator

SEED = 2**31 + 977
# the knowns a laplace run finds by depth 3 (the quadrupole comes at 4)
BY_DEPTH_3 = ("X", "X*Y", "log(X**2 + Y**2)")


def small_cell(depth: int, **search) -> spec.Cell:
    cell = spec.load_cell("laplace.d5.heavy")
    cfg = copy.deepcopy(cell.config)
    cfg["max_depth"] = depth
    if depth < 4:
        cfg["knowns"] = {k: v for k, v in cfg["knowns"].items()
                         if k in BY_DEPTH_3}
    cell.config = cfg
    cell.traffic = dict(cell.traffic, search_config=dict(
        cell.traffic["search_config"], **search))
    return cell


def run(cell: spec.Cell) -> dict:
    result, _ = harness.run_cell(cell, SEED, 0.0, False, device="cpu")
    return result


def failing(result: dict):
    return sorted(k for k, c in result["checks"].items()
                  if c["value"] > c["limit"])


def test_a_sound_run_is_correct():
    result = run(small_cell(3))
    assert result["correct"] and result["failed"] == 0, result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    # the heavy-check cell holds host_peak_gib and setup_s end to end
    assert set(result["metrics"]) == {"host_peak_gib", "setup_s"}


def test_a_depth_that_leaves_the_state_unchanged_fails(monkeypatch):
    orig = Enumerator.vector_batches_at_depth

    def nothing_at_the_last_depth(self, depth, *a, **kw):
        if depth == 3:
            return iter(())
        return orig(self, depth, *a, **kw)

    monkeypatch.setattr(Enumerator, "vector_batches_at_depth",
                        nothing_at_the_last_depth)
    result = run(small_cell(3))
    assert not result["correct"]
    assert "count_gap" in failing(result)


def test_half_of_each_batch_left_out_fails(monkeypatch):
    orig = Enumerator.vector_batches_at_depth

    def halves(self, depth, *a, **kw):
        for op, a_u, b_u in orig(self, depth, *a, **kw):
            k = (len(a_u) + 1) // 2
            yield op, a_u[:k], (None if b_u is None else b_u[:k])

    monkeypatch.setattr(Enumerator, "vector_batches_at_depth", halves)
    result = run(small_cell(3))
    assert not result["correct"]
    assert {"count_gap", "count_d12_mismatch"} & set(failing(result))


@pytest.mark.parametrize("case", ["sound", "control", "altered_answer"])
def test_the_control_and_an_altered_answer_fail_at_depth_4(case,
                                                           monkeypatch):
    """The control is the program's own float32 path: every screen passer
    accepted without the float64 recheck (``f64_skip_below``)."""
    search = {"f64_skip_below": 1.0} if case == "control" else {}
    if case == "altered_answer":
        orig = pipeline.DiscoveryEngine._gray_numeric

        def every_recheck_passes(self, part):
            const64, finite, relmax = orig(self, part)
            return (const64, np.ones_like(finite),
                    np.zeros_like(relmax))

        monkeypatch.setattr(pipeline.DiscoveryEngine, "_gray_numeric",
                            every_recheck_passes)
    result = run(small_cell(4, **search))
    if case == "sound":
        assert result["correct"], result["checks"]
    else:
        assert not result["correct"]
        assert {"count_gap", "verdict_mismatch"} & set(failing(result)), \
            result["checks"]
