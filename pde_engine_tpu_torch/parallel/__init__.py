"""Screen kernels and verdicts of the port; the library entry points
``make_search_kernel`` and the candidate mesh, as in
``pde_engine_tpu/parallel/__init__.py``."""

from .mesh import (CANDIDATE_AXIS, CandidateMesh,  # noqa: F401
                   candidate_mesh, pad_to_multiple, shard_ranges)
from .search import (ScreenResult, make_search_kernel,  # noqa: F401
                     make_search_kernel_raw, make_tape_jets_kernel,
                     register_residual)
