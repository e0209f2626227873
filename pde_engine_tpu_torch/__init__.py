"""pde_engine_tpu_torch — the PyTorch/CUDA port of ``pde_engine_tpu``.

The same depth-by-depth discovery engine on one NVIDIA GPU: the screen
kernels (surface op on Taylor jets, PDE residual, fingerprint snap and
hash, verdict packing) are hand-written CUDA for Hopper (``csrc/``),
built with ``nvcc`` on first use; every kernel has a plain torch twin
that the CPU path and the tests run.  The host side (enumerator, problem
classes, dedup map, run DB, the C++ ingest core) is the port's own copy
of the JAX package's JAX-free modules, under the same module names.
Nothing here imports jax or ``pde_engine_tpu``.
"""

__version__ = "0.1.0"


def load_problem(name: str):
    """Top-level convenience, as ``pde_engine_tpu.load_problem``: the
    port's problem of that registry name (``models.load_problem``)."""
    from .models import load_problem as _lp
    return _lp(name)
