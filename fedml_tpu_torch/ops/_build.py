"""Build the port's native code and load it with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface, so it compiles in
seconds (no PyTorch headers) into ``build/fedml_tpu_torch/`` at the root
of the checkout, at first use, for ``sm_90a`` (Hopper). Each
``csrc/<name>.cpp`` is host code (the finite-field LCC kernels of secure
aggregation) and compiles the same way with the host C++ compiler
(:func:`build_host`); a ``csrc/<name>.cpp`` with a ``main`` (the epoll
broker) compiles into an executable (:func:`build_executable`). The file
name carries a hash of its source and flags, so an edited source is
rebuilt and a stale one is never loaded. Nothing is built when a module
is imported: the first call builds it, and its time counts into the open
span's ``compile_ms`` (``telemetry.note_kernel_build``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fedml_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-fPIC", "-shared")
EXE_FLAGS = ("-O3", "-std=c++17", "-Wall")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's stderr (ptxas register / shared-memory report) of each build made
# by this process, for callers that want to print it
build_logs: Dict[str, str] = {}
# observers of the build cache: fn(hit) for every build request
_cache_listeners: List[Callable[[bool], None]] = []


def add_cache_listener(fn: Callable[[bool], None]) -> None:
    """Call ``fn(hit)`` at every build request: ``hit`` when the library or
    executable was already built (``telemetry.device_stats`` counts them)."""
    if fn not in _cache_listeners:
        _cache_listeners.append(fn)


def _cached(out: Path) -> bool:
    hit = out.exists()
    for fn in list(_cache_listeners):
        fn(hit)
    return hit


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises RuntimeError if none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels are built from source at first use")


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++`` or ``g++`` on PATH.
    Raises RuntimeError if none exists."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(c) if c else None
        if found:
            return found
    raise RuntimeError("no host C++ compiler found ($CXX, c++, g++): the port's host "
                       "libraries are built from source at first use")


def _digest(name: str, suffix: str, flags) -> str:
    src = CSRC / f"{name}{suffix}"
    return hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]


def library_path(name: str, suffix: str = ".cu", flags=NVCC_FLAGS) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name, suffix, flags)}.so"


def executable_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name, '.cpp', EXE_FLAGS)}"


def _compile(name: str, suffix: str, compiler: str, flags, out: Path) -> Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders (several
    # processes on one checkout) never load a half-written library
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(CSRC / f"{name}{suffix}")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    # the build's time goes to the open span's compile_ms
    from fedml_tpu_torch.telemetry.spans import note_kernel_build

    note_kernel_build(f"{name}{suffix}", (time.perf_counter() - t0) * 1e3)
    if proc.returncode != 0:
        raise RuntimeError(
            f"{os.path.basename(compiler)} failed to build {name} (exit "
            f"{proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    build_logs[name] = proc.stderr
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    return out if _cached(out) else _compile(name, ".cu", find_nvcc(), NVCC_FLAGS, out)


def build_host(name: str) -> Path:
    """Compile the host library ``csrc/<name>.cpp`` unless it already
    exists; a failed build raises with the compiler's message."""
    out = library_path(name, ".cpp", CXX_FLAGS)
    return out if _cached(out) else _compile(name, ".cpp", find_cxx(), CXX_FLAGS, out)


def build_executable(name: str) -> Path:
    """Compile the host program ``csrc/<name>.cpp`` unless it already
    exists; a failed build raises with the compiler's message."""
    with _lock:
        out = executable_path(name)
        return out if _cached(out) else _compile(name, ".cpp", find_cxx(), EXE_FLAGS, out)


def load_host(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host library ``name``, once per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(str(build_host(name)))
        return lib


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the kernel library ``name``, once per
    process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.fedml_cuda_error_string.argtypes = [ctypes.c_int]
            lib.fedml_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = lib.fedml_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
