"""The port's public surface against the JAX package's, module by module.

One case per module of ``pde_engine_tpu`` (every ``.py`` file of the
package, found on disk).  The case takes the module's public names:

- of a package's ``__init__``, every public name its code binds;
- of any other module, the public top-level names it defines (their
  ``__module__`` is the module itself); a name it imports from another
  module of the package is checked in that module;
- of each such class, its public methods and class attributes.

The port's module of the same path must have every one of them, except
the deliberate absences in ``ABSENT``, each with its reason.  Each absence
must still be an absence: a name ported later leaves the list.

``parallel/pallas_engine.py`` is absent as a module: its four Pallas
kernels map to the hand CUDA kernels of ``parallel/cuda_engine.py``
(``PALLAS_TO_CUDA``), and ``test_pallas_kernels_map_to_cuda_kernels``
holds that mapping to the source: every function that reaches
``pl.pallas_call``, and every public kernel maker, maps to a CUDA entry
point that has its plain twin.

``__graft_entry__.py`` is not a module of the package; its counterparts
are in ``pde_engine_tpu_torch/dryrun.py`` (``test_graft_entry_surface``).

Not ported, and not modules of the package either: ``tools/profile_kernel.py``
(TPU stage timing) and ``tools/warm_kernels.py`` (XLA compile-cache
warming).  ``chip_smoke.py`` phases 2-3 build and time the CUDA kernels,
and an nvcc build takes seconds.
"""

import ast
import importlib
import inspect
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "pde_engine_tpu")
PORT_ROOT = os.path.join(REPO, "pde_engine_tpu_torch")

_XLA_KERNEL = ("an XLA kernel of the per-op and mesh paths; the hand CUDA "
               "kernels of parallel/cuda_engine.py and their plain torch "
               "twins take its role")
_SHARDING = ("a JAX sharding of a batch; the port's mesh splits a batch "
             "into exact shard ranges (parallel/mesh.shard_ranges)")

# "module" (a path under the package, without .py) or "module:name" ->
# why the port deliberately has no counterpart
ABSENT = {
    "ops/lanes": "the TPU's lane-major jet layout of a Pallas tile; the "
                 "CUDA kernels read candidate-major cache rows",
    "utils/compile_cache": "XLA's persistent compile cache; the port "
                           "builds each kernel library once per digest "
                           "with nvcc (utils/cuda_build.py)",
    "parallel/pallas_engine": "the four Pallas TPU kernels; each maps to "
                              "a hand CUDA kernel of "
                              "parallel/cuda_engine.py (PALLAS_TO_CUDA)",
    "parallel/incremental:make_universal_kernel": _XLA_KERNEL,
    "parallel/incremental:make_universal_kernel_raw": _XLA_KERNEL,
    "parallel/incremental:make_op_kernel": _XLA_KERNEL,
    "parallel/incremental:make_select_kernel": _XLA_KERNEL,
    "parallel/incremental:make_append_kernel": _XLA_KERNEL,
    "parallel/mesh:replicated": _SHARDING,
    "parallel/mesh:shard_batch": _SHARDING,
}

# function of pallas_engine.py -> the CUDA entry point of
# parallel/cuda_engine.py that computes what it computes
PALLAS_TO_CUDA = {
    "_op_tile_runner": "universal",
    "make_pallas_universal_kernel": "universal",
    "make_pallas_op_kernel": "universal",
    "make_pallas_segmented_kernel": "segmented",
    "make_pallas_structured_kernel": "structured",
    "make_pallas_tiled_kernel": "tiled",
}


def _jax_modules():
    out = []
    for dirpath, dirs, files in os.walk(JAX_ROOT):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fn in sorted(files):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), JAX_ROOT)
                out.append(rel[:-3].replace(os.sep, "/"))
    return out


MODULES = _jax_modules()


def _dotted(rel: str, package: str) -> str:
    parts = [p for p in rel.split("/") if p != "__init__"]
    return ".".join([package] + parts)


def _bound_names(path: str):
    """The names a module's own top-level code binds."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return names


def _home(obj):
    """The module of the package that defines ``obj``, as ``ABSENT``
    names modules, or None."""
    mod = getattr(obj, "__module__", None) or ""
    if not mod.startswith("pde_engine_tpu."):
        return None
    return mod[len("pde_engine_tpu."):].replace(".", "/")


def _public_surface(rel: str):
    """[(name, object)] of the JAX module's public surface."""
    mod = importlib.import_module(_dotted(rel, "pde_engine_tpu"))
    if rel.endswith("__init__"):
        path = os.path.join(JAX_ROOT, rel + ".py")
        return [(n, getattr(mod, n)) for n in _bound_names(path)
                if not n.startswith("_")]
    return [(n, v) for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and getattr(v, "__module__", None) == mod.__name__]


@pytest.mark.parametrize("rel", MODULES)
def test_port_has_the_module_surface(rel):
    if rel in ABSENT:
        assert not os.path.exists(os.path.join(PORT_ROOT, rel + ".py")), (
            f"{rel} is ported: take it out of ABSENT")
        return
    port = importlib.import_module(_dotted(rel, "pde_engine_tpu_torch"))
    # a package holds a submodule once anything imports it: the names of
    # an __init__ must be bound by its own code
    bound = (set(_bound_names(os.path.join(PORT_ROOT, rel + ".py")))
             if rel.endswith("__init__") else set(vars(port)))
    surface = _public_surface(rel)
    assert surface or rel == "__main__", f"{rel}: no public name found"
    own = {k.split(":")[1] for k in ABSENT if k.startswith(rel + ":")}
    assert own <= {n for n, _ in surface}, (rel, own)
    missing = []
    for name, obj in surface:
        home = _home(obj) if rel.endswith("__init__") else rel
        if f"{home}:{name}" in ABSENT:
            assert not hasattr(port, name), (
                f"{rel}.{name} is ported: take it out of ABSENT")
            continue
        if name not in bound:
            missing.append(name)
            continue
        if inspect.isclass(obj) and _home(obj) == rel:
            ported = getattr(port, name)
            missing += [f"{name}.{m}" for m in vars(obj)
                        if not m.startswith("_") and not hasattr(ported, m)]
    assert not missing, f"pde_engine_tpu_torch/{rel}.py lacks {missing}"


def _pallas_call_sites():
    """{top-level function of pallas_engine.py: [line of each
    ``pallas_call`` in it]}."""
    with open(os.path.join(JAX_ROOT, "parallel", "pallas_engine.py")) as f:
        tree = ast.parse(f.read())
    sites = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Attribute) and node.attr == "pallas_call":
                sites.setdefault(fn.name, []).append(node.lineno)
    return sites


def test_pallas_kernels_map_to_cuda_kernels():
    """Every function of ``pallas_engine.py`` that reaches
    ``pl.pallas_call`` and every public kernel maker maps to a CUDA entry
    point of the port with its plain twin, and ``chip_smoke.py`` names a
    ``pallas_call`` line of that function as the kernel it replaces."""
    from pde_engine_tpu.parallel import pallas_engine
    from pde_engine_tpu_torch.parallel import cuda_engine

    sites = _pallas_call_sites()
    assert len(sites) == 4 and set(sites) <= set(PALLAS_TO_CUDA), sites
    makers = {n for n in vars(pallas_engine) if n.startswith("make_pallas_")}
    assert makers | set(sites) == set(PALLAS_TO_CUDA), makers
    assert set(PALLAS_TO_CUDA.values()) == set(cuda_engine.KERNELS)
    for kernel in cuda_engine.KERNELS:
        assert callable(getattr(cuda_engine, kernel))
        assert callable(getattr(cuda_engine, f"{kernel}_ref"))

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    replaces = next(ast.literal_eval(n.value) for n in tree.body
                    if isinstance(n, ast.Assign)
                    and getattr(n.targets[0], "id", "") == "REPLACES")
    assert set(replaces) == set(cuda_engine.KERNELS)
    for kernel, where in replaces.items():
        path, line = where.rsplit(":", 1)
        assert path == "pde_engine_tpu/parallel/pallas_engine.py"
        fns = [fn for fn, lines in sites.items() if int(line) in lines]
        assert len(fns) == 1 and PALLAS_TO_CUDA[fns[0]] == kernel, (
            kernel, where, sites)


def test_graft_entry_surface():
    """``__graft_entry__.py``'s public functions have counterparts in
    ``pde_engine_tpu_torch/dryrun.py``."""
    import sys
    sys.path.insert(0, REPO)
    import __graft_entry__ as g

    from pde_engine_tpu_torch import dryrun
    public = [n for n, v in vars(g).items() if not n.startswith("_")
              and inspect.isfunction(v) and v.__module__ == g.__name__]
    assert sorted(public) == ["dryrun_multichip", "entry"]
    assert all(callable(getattr(dryrun, n, None)) for n in public), public
