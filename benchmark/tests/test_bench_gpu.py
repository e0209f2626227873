"""One whole cell on the card (marked ``gpu``; skips without a card).

    python -m pytest benchmark/tests -m gpu -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec


@pytest.mark.gpu
def test_a_laplace_cell_runs_and_is_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "laplace.d5.heavy.no_families",
         "--seed", str(2**31 + 101), "--seconds", "1", "--trace", "1"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["busy_s"] > 0
    assert "screen_roofline" in result["metrics"]
    assert list(result)[-1] == "checks"
