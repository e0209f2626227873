"""The port's library calls against the JAX package's on the CPU, and
where the port builds its kernels and its native core.

- ``pde_engine_tpu_torch.load_problem`` against ``pde_engine_tpu.
  load_problem`` for every name of the JAX registry (the four families
  and their aliases): the same class, slug, residual order and key,
  screen tolerance, points and knowns; an unknown name raises
  ``ValueError`` in both.
- ``DiscoveryEngine.summary()`` after force_free to depth 2 and laplace
  to depth 3 against the JAX engine's on the same problem: the same keys,
  and in each depth's entry the JAX ``DepthStats`` fields; the counts,
  totals, knowns and ``candidates_screened`` equal (both count the
  candidates screened, the depth-1 primitives and the knowns through the
  float64 oracle and every later candidate once, no pad row); the
  seconds are timings and are held only to be floats >= 0.
- ``dryrun.entry(device="cpu")`` against ``__graft_entry__.entry()`` run
  as ``tests/test_graft_entry.py`` runs it (``jax.jit``): equal example
  arguments; every verdict flag and both fingerprint hashes equal;
  ``rel_max`` within 1e-4 relative where it is above 1e-3 and under 1e-6
  on both sides where either is (the knowns: roundoff of a zero
  residual), the tolerance of ``tests/test_torch_tape.py``; the snapped
  fingerprint jets within 1e-6 of max(|v|, 1).  The seven knowns pass
  the screen and ``rho*z`` does not.
- The build root (``utils/cuda_build.build_root``).  In this checkout it
  is ``build/torch_ext``.  A copy of the package alone, outside any
  checkout (as ``pip install`` lays it out), with ``HOME`` and
  ``XDG_CACHE_HOME`` in a temporary directory, builds its native ingest
  core and the host build of the kernel body (what
  ``tests/test_torch_kernels.py::host_rows`` builds) under the user cache
  directory and writes nothing inside itself; a build that fails still
  raises with the compiler's output.  The subprocess runs with
  ``PYTHONDONTWRITEBYTECODE`` so that Python's own bytecode cache stays
  out of the comparison.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import pde_engine_tpu
import pde_engine_tpu_torch
from pde_engine_tpu.models.base import _REGISTRY as JAX_REGISTRY
from pde_engine_tpu.pipeline import DiscoveryEngine as JaxDiscoveryEngine
from pde_engine_tpu.utils import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch import dryrun
from pde_engine_tpu_torch.pipeline import DiscoveryEngine
from pde_engine_tpu_torch.utils import SearchConfig, cuda_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_RTOL = 1e-4
ZERO_RES = 1e-6
FP_ATOL = 1e-6
DEPTH_FIELDS = ("depth", "candidates", "unique", "valid", "seconds",
                "t_enum", "t_device", "t_ingest", "t_gray")
TIMINGS = ("seconds", "t_enum", "t_device", "t_ingest", "t_gray")


@pytest.mark.parametrize("name", sorted(JAX_REGISTRY))
def test_load_problem_equals_jax(name):
    jp = pde_engine_tpu.load_problem(name)
    tp = pde_engine_tpu_torch.load_problem(name)
    assert type(tp).__name__ == type(jp).__name__
    assert type(tp).__module__.startswith("pde_engine_tpu_torch.models.")
    for attr in ("slug", "residual_order", "screen_rtol", "confirm_rtol",
                 "known_solutions", "primitive_strs"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert tp.get_residual_key() == jp.get_residual_key()
    for attr in ("screen_points", "fingerprint_points"):
        np.testing.assert_array_equal(np.asarray(getattr(tp, attr)),
                                      np.asarray(getattr(jp, attr)))


def test_load_problem_unknown_name_raises():
    for load in (pde_engine_tpu.load_problem,
                 pde_engine_tpu_torch.load_problem):
        with pytest.raises(ValueError, match="Unknown problem"):
            load("no_such_problem")


@pytest.mark.parametrize("name,depth", [("force_free", 2), ("laplace", 3)])
def test_summary_equals_jax(name, depth):
    jax_eng = JaxDiscoveryEngine(pde_engine_tpu.load_problem(name),
                                 JaxSearchConfig(max_depth=depth))
    jax_eng.run(depth)
    want = jax_eng.summary()
    eng = DiscoveryEngine(pde_engine_tpu_torch.load_problem(name),
                          SearchConfig(max_depth=depth), device="cpu")
    eng.run(depth)
    got = eng.summary()
    assert set(got) == set(want)
    for key in ("problem", "total_candidates", "total_unique",
                "total_valid", "paper_solutions", "candidates_screened"):
        assert got[key] == want[key], key
    for g, w in zip(got["depths"], want["depths"]):
        assert tuple(g) == tuple(w) == DEPTH_FIELDS
        for k in DEPTH_FIELDS:
            if k in TIMINGS:
                assert isinstance(g[k], float) and g[k] >= 0.0, (k, g[k])
            else:
                assert g[k] == w[k], (g["depth"], k)
    assert len(got["depths"]) == len(want["depths"]) == depth
    assert isinstance(got["device_seconds"], float)
    assert got["device_seconds"] >= 0.0
    # what candidates_screened counts: the oracle's rows (depth-1
    # primitives and the knowns) and every launched candidate once
    launched = sum(v["candidates"] for v in eng.launched_rows().values())
    oracle = got["depths"][0]["candidates"] + len(eng.problem.known_solutions)
    assert got["candidates_screened"] == oracle + launched


def test_entry_equals_jax_entry():
    import jax
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    fn, jargs = g.entry()
    want = jax.jit(fn)(*jargs)
    jax.block_until_ready(want)
    kernel, args = dryrun.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    for a, ja in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    got = kernel(*args)
    assert got.screen_ok.shape[0] == args[0].shape[0] == 8
    for f in ("screen_ok", "nonfinite", "is_const", "fp_finite", "fp_a",
              "fp_b"):
        np.testing.assert_array_equal(
            getattr(got, f).numpy().astype(np.int64),
            np.asarray(getattr(want, f)).astype(np.int64), err_msg=f)
    ok = got.screen_ok.numpy()
    assert ok[:7].all() and not ok[7], ok     # the knowns, then rho*z
    r_got = got.rel_max.numpy().astype(np.float64)
    r_want = np.asarray(want.rel_max, np.float64)
    big = np.maximum(r_got, r_want) > 1e-3
    np.testing.assert_allclose(r_got[big], r_want[big], rtol=REL_RTOL)
    assert (np.maximum(r_got, r_want)[~big] < ZERO_RES).all(), (r_got,
                                                                r_want)
    f_got = got.fp_vals.numpy().astype(np.float64)
    f_want = np.asarray(want.fp_vals, np.float64)
    assert np.max(np.abs(f_got - f_want)
                  / np.maximum(np.abs(f_want), 1.0)) <= FP_ATOL


def test_entry_runs_on_the_card_unless_asked_for_the_cpu():
    """``entry()`` defaults to ``cuda``; without a card that raises, and
    nothing falls back to the CPU."""
    if torch.cuda.is_available():
        _, args = dryrun.entry()
        assert all(a.device.type == "cuda" for a in args)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            dryrun.entry()


def test_checkout_builds_into_build_torch_ext():
    from pde_engine_tpu_torch.utils import native
    root = os.path.join(REPO, "build", "torch_ext")
    assert cuda_build.build_root() == root
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    core = native.load_core()
    if os.environ.get("PDE_ENGINE_NO_NATIVE"):
        assert core is None
    else:
        assert os.path.dirname(os.path.dirname(core._name)) == root


_INSTALLED = r"""
import json, os, sys
copy = sys.argv[1]
import pde_engine_tpu_torch as pkg
assert os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) \
    == copy, pkg.__file__
from pde_engine_tpu_torch.parallel import cuda_engine as ce
from pde_engine_tpu_torch.pipeline import cuda_emit_spec
from pde_engine_tpu_torch.utils import cuda_build, native
p = pkg.load_problem("force_free")
core = native.load_core()
host = cuda_build.load_host_library(
    ce.header_text(cuda_emit_spec(p, p.screen_rtol)))
try:
    cuda_build.load_host_library("#error a deliberately broken build\n")
    failed = None
except RuntimeError as e:
    failed = str(e)
print(json.dumps({"root": cuda_build.build_root(),
                  "core": core and core._name, "host": host._name,
                  "failed": failed}))
"""


def _tree(d):
    out = {}
    for dirpath, _, files in os.walk(d):
        for fn in files:
            path = os.path.join(dirpath, fn)
            st = os.stat(path)
            out[os.path.relpath(path, d)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.mark.parametrize("xdg", [True, False], ids=["xdg_cache_home",
                                                    "home_cache"])
def test_installed_copy_builds_in_the_user_cache(tmp_path, xdg):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    site = tmp_path / "site-packages"
    shutil.copytree(os.path.join(REPO, "pde_engine_tpu_torch"),
                    site / "pde_engine_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(site)
    home = tmp_path / "home"
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XDG_CACHE_HOME",
                        "PDE_ENGINE_NO_NATIVE")}
    env.update(HOME=str(home), PYTHONPATH=str(site),
               PYTHONDONTWRITEBYTECODE="1")
    cache = home / ".cache" / "pde_engine_tpu_torch"
    if xdg:
        env["XDG_CACHE_HOME"] = str(tmp_path / "xdg")
        cache = tmp_path / "xdg" / "pde_engine_tpu_torch"
    r = subprocess.run([sys.executable, "-c", _INSTALLED, str(site)],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["root"] == str(cache)
    for key, lib in (("core", "libpde_ingest.so"),
                     ("host", "libpde_screen_host.so")):
        assert out[key] is not None, key
        assert os.path.dirname(os.path.dirname(out[key])) == str(cache)
        assert os.path.basename(out[key]) == lib
        assert os.path.exists(out[key])
    assert (out["failed"] or "").startswith(
        "g++ failed building host_harness.cpp")
    assert _tree(site) == before
