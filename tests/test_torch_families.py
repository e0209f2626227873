"""Kerr, laplace and grad_shafranov through the port, against the JAX
package on the CPU.

- Discovery to depth 3: the port's segmented path against the JAX
  engine's per-op path (the XLA universal kernel), each side on its own
  problem: depths 1-2 exact, depth-3 uniques and valid within 0.2% (the
  bound ``tests/test_torch_pipeline.py`` states for force_free), the
  same candidates per depth and the same known solutions.  Kerr finds no
  valid row at a = 1/10; its monopole validates at its anchor a -> 0 on
  both sides with the same relative residual.
- The order-2 residuals of kerr and grad_shafranov in the port's torch
  ``xp`` against the JAX package's on ``jax.numpy``, on seeded jets at
  each problem's screen points: every residual and scale within 16
  float32 ulp of the point's scale.  Both round each operation to
  float32, but XLA:CPU contracts ``x*y + z`` into FMAs, which moves a
  term by up to half an ulp of itself; the residual sums four terms.
"""

import numpy as np
import pytest
import torch

from pde_engine_tpu.models import load_problem as jax_load_problem
from pde_engine_tpu.utils.config import SearchConfig as JaxSearchConfig
from pde_engine_tpu_torch.models import load_problem
from pde_engine_tpu_torch.ops.torch_xp import txp
from pde_engine_tpu_torch.utils.config import SearchConfig

FAMILIES = ["kerr_magnetosphere", "laplace", "grad_shafranov"]
D3_SPREAD = 0.002
RESIDUAL_ULPS = 16
# uniques / valid at depths 1-2, the same on both sides and on the TPU
EXACT = {"kerr_magnetosphere": [(9, 0), (439, 0)],
         "laplace": [(4, 2), (61, 17)],
         "grad_shafranov": [(4, 1), (66, 7)]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=FAMILIES)
def engines(request):
    from pde_engine_tpu.pipeline import DiscoveryEngine as JaxEngine
    from pde_engine_tpu_torch.pipeline import DiscoveryEngine
    name = request.param
    jax_eng = JaxEngine(jax_load_problem(name),
                        JaxSearchConfig(max_depth=3, use_segmented=False))
    jax_eng.run(3)
    port = DiscoveryEngine(load_problem(name), SearchConfig(max_depth=3),
                           device="cpu")
    port.run(3)
    return name, jax_eng, port


def _knowns(eng):
    return {r.paper_solution_name for r in eng.valid_rows
            if r.paper_solution_name}


def test_depth3_counts_match_jax(engines):
    name, jax_eng, port = engines
    js = [(s.unique, s.valid) for s in jax_eng.stats]
    ps = [(s.unique, s.valid) for s in port.stats]
    assert ps[:2] == js[:2] == EXACT[name]
    (pu, pv), (ju, jv) = ps[2], js[2]
    assert abs(pu - ju) <= D3_SPREAD * ju, (pu, ju)
    assert abs(pv - jv) <= D3_SPREAD * jv, (pv, jv)
    assert [s.candidates for s in port.stats] == \
        [s.candidates for s in jax_eng.stats]
    assert port.segmented_dispatches > 0


def test_knowns_match_jax(engines):
    name, jax_eng, port = engines
    assert _knowns(port) == _knowns(jax_eng)
    if name == "kerr_magnetosphere":
        assert port.valid_rows == [] and all(s.valid == 0
                                             for s in jax_eng.stats)
    else:
        assert _knowns(port)


@pytest.mark.parametrize("name", FAMILIES)
def test_validate_knowns_match_jax(name):
    """Each known solution's verdict, relative residual and note; kerr's
    monopole is valid at its anchor a -> 0 only."""
    port, jax_p = load_problem(name), jax_load_problem(name)
    assert port.known_solutions == jax_p.known_solutions
    for expr in port.known_solutions:
        ok, rel, note = port.validate_known(expr)
        j_ok, j_rel, j_note = jax_p.validate_known(expr)
        assert (ok, note) == (j_ok, j_note)
        np.testing.assert_allclose(rel, j_rel, rtol=1e-6, atol=1e-12)
        if name == "kerr_magnetosphere":
            assert ok and note == "at anchor a→0"


@pytest.mark.parametrize("name", ["kerr_magnetosphere", "grad_shafranov"])
def test_residual_matches_jnp(name):
    import jax.numpy as jnp
    p, jp = load_problem(name), jax_load_problem(name)
    rng = np.random.default_rng(7)
    P = len(p.screen_points)
    u = rng.normal(0.0, 1.0, size=(512, P, 6)).astype(np.float32)
    u[::17] = 0.0
    pts = np.asarray(p.screen_points, np.float32)
    res, scale = p.residual_fn(torch.from_numpy(u), torch.from_numpy(pts),
                               txp)
    j_res, j_scale = jp.residual_fn(jnp.asarray(u), jnp.asarray(pts), jnp)
    res, scale = res.numpy(), scale.numpy()
    j_res, j_scale = np.asarray(j_res), np.asarray(j_scale)
    assert res.dtype == j_res.dtype == np.float32
    assert np.isfinite(res).all() and np.isfinite(scale).all()
    ulp = np.spacing(np.maximum(j_scale, np.float32(1e-30)))
    assert (np.abs(res.astype(np.float64) - j_res)
            <= RESIDUAL_ULPS * ulp).all()
    assert (np.abs(scale.astype(np.float64) - j_scale)
            <= RESIDUAL_ULPS * ulp).all()
    # the zero jets: residual and scale exactly 0 on both sides
    assert (res[::17] == 0).all() and (j_res[::17] == 0).all()
