"""Build and load the hand-written screen kernels.

Counterpart of the native-core build in ``pde_engine_tpu/utils/native.py``
and of the JAX compile cache: on first use the CUDA sources in
``pde_engine_tpu_torch/csrc/`` are compiled with ``nvcc`` for ``sm_90a``,
together with the jet-algebra header emitted for the problem
(``ops/cuda_emit.py``), into ``<build root>/<digest>/``.  The digest
covers the sources, the emitted header and the compiler flags, so a
changed kernel or problem builds anew and an unchanged one loads at once.
The build root (:func:`build_root`) is ``build/torch_ext`` of the
checkout when the package sits in one, and a user cache directory when
it is installed (``pip install``: its parent is ``site-packages``).

The library exposes plain ``extern "C"`` launchers taking device pointers,
sizes and the CUDA stream; it is bound with ``ctypes`` and does not link
against torch, so it builds without PyTorch's headers (about 6 s of nvcc
on an NVIDIA H100 80GB HBM3 machine, 700 W limit).

``-fmad=false`` keeps the kernel's rounding equal to eager float32 torch
and to the non-contracting TPU; denormals stay on and fast math stays off.
A build failure raises with the compiler's error output; nothing falls
back.  The same body builds for the host with ``g++ -ffp-contract=off``
so that the CPU tests can run the kernel's arithmetic without a GPU.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
_SOURCES = ("screen_body.cuh", "screen_kernel.cu", "host_harness.cpp")

NVCC_FLAGS = ["-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-fmad=false", "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-fPIC", "-shared"]

_lock = threading.Lock()
_build_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ct.CDLL] = {}


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(_CSRC.rstrip(os.sep)))


def _checkout_build_root():
    """``<checkout>/build/torch_ext`` when the package sits in a checkout
    of the repository (its parent holds the ``pyproject.toml`` that
    names the package) and that directory can be created and written;
    else None."""
    root = repo_root()
    try:
        with open(os.path.join(root, "pyproject.toml")) as f:
            if "pde_engine_tpu_torch" not in f.read():
                return None
        out = os.path.join(root, "build", "torch_ext")
        os.makedirs(out, exist_ok=True)
    except OSError:
        return None
    return out if os.access(out, os.W_OK) else None


def build_root() -> str:
    """Where the kernels and the native ingest core build: the checkout's
    ``build/torch_ext``, else the user cache directory,
    ``$XDG_CACHE_HOME/pde_engine_tpu_torch`` or
    ``~/.cache/pde_engine_tpu_torch`` when ``XDG_CACHE_HOME`` is unset
    (created here; raises if it cannot be)."""
    root = _checkout_build_root()
    if root is None:
        base = (os.environ.get("XDG_CACHE_HOME")
                or os.path.join(os.path.expanduser("~"), ".cache"))
        root = os.path.join(base, "pde_engine_tpu_torch")
        os.makedirs(root, exist_ok=True)
    return root


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "CUDA screen kernels cannot be built")


def _digest(header_text: str, flags: List[str], tag: str) -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(header_text.encode())
    h.update(" ".join(flags + [tag]).encode())
    return h.hexdigest()[:16]


def _build(cmd_head: List[str], flags: List[str], source: str,
           header_text: str, tag: str, lib_name: str) -> str:
    """Build one library, once per digest; libraries of other digests
    build at the same time in other threads."""
    out_dir = os.path.join(build_root(), _digest(header_text, flags, tag))
    with _lock:
        lock = _build_locks.setdefault(out_dir, threading.Lock())
    with lock:
        return _build_locked(cmd_head, flags, source, header_text, out_dir,
                             lib_name)


def _build_locked(cmd_head: List[str], flags: List[str], source: str,
                  header_text: str, out_dir: str, lib_name: str) -> str:
    so = os.path.join(out_dir, lib_name)
    if os.path.exists(so):
        return so
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "jet_ops.h"), "w") as f:
        f.write(header_text)
    tmp = f"{so}.tmp{os.getpid()}"
    cmd = (cmd_head + flags + ["-I", out_dir, "-I", _CSRC,
                               os.path.join(_CSRC, source), "-o", tmp])
    r = subprocess.run(cmd, capture_output=True, text=True)
    with open(os.path.join(out_dir, f"{lib_name}.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd_head[0]} failed building {source} "
                           f"(exit {r.returncode}):\n{r.stderr[-8000:]}")
    os.replace(tmp, so)
    return so


def _load(so: str) -> ct.CDLL:
    lib = _loaded.get(so)
    if lib is None:
        lib = ct.CDLL(so)
        _loaded[so] = lib
    return lib


def load_screen_library(header_text: str) -> ct.CDLL:
    """nvcc-build (once per digest) and load the CUDA screen kernels."""
    so = _build([nvcc_path()], NVCC_FLAGS, "screen_kernel.cu", header_text,
                "cuda", "libpde_screen.so")
    with _lock:
        lib = _load(so)
    P, I, F, LL = ct.c_void_p, ct.c_int, ct.c_float, ct.c_longlong
    lib.pde_screen_dims.argtypes = [P]
    lib.pde_screen_geometry.argtypes = [P]
    lib.pde_screen_segmented.argtypes = [P, P, LL, P, P, P, F, I, P, P, P, P]
    lib.pde_screen_structured.argtypes = [P, P, LL, I, I, I, I, P, F, I, I,
                                          P, P, P, P]
    lib.pde_screen_tiled.argtypes = [P, P, LL, P, P, P, P, F, I, P, P, P, P]
    lib.pde_screen_universal.argtypes = [P, P, LL, P, I, P, F, I, I, P, P, P,
                                         P]
    for fn in (lib.pde_screen_dims, lib.pde_screen_geometry,
               lib.pde_screen_segmented,
               lib.pde_screen_structured, lib.pde_screen_tiled,
               lib.pde_screen_universal):
        fn.restype = ct.c_int
    return lib


def load_host_library(header_text: str) -> ct.CDLL:
    """g++-build (once per digest) and load the host screen body."""
    so = _build(["g++"], GXX_FLAGS, "host_harness.cpp", header_text, "host",
                "libpde_screen_host.so")
    with _lock:
        lib = _load(so)
    P, I, F = ct.c_void_p, ct.c_int, ct.c_float
    lib.host_dims.argtypes = [P]
    lib.host_dims.restype = I
    for fn in (lib.host_screen_rows, lib.host_screen_rows_grouped):
        fn.argtypes = [I, P, P, P, P, P, P, F, P, P, P]
        fn.restype = None
    lib.host_residual.argtypes = [I, P, P, P, P]
    lib.host_residual.restype = None
    return lib


def build_log(header_text: str) -> str:
    """The nvcc command and its output (ptxas register and spill report)
    for the library built from ``header_text``."""
    out_dir = os.path.join(build_root(),
                           _digest(header_text, NVCC_FLAGS, "cuda"))
    with open(os.path.join(out_dir, "libpde_screen.so.log")) as f:
        return f.read()
