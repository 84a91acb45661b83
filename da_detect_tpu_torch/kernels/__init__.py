"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by its own ``nvcc`` process for
``sm_90a`` (Hopper) into a shared library with a plain C interface, and loaded
with ``ctypes``. Sources that include PyTorch's headers take minutes to
compile; these take seconds. All sources build in parallel, at first use,
into ``build/`` beside this file (listed in ``.gitignore``). A library's file
name carries a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds.

Nothing here falls back: on a machine with a card, a missing ``nvcc`` or a
failed build raises. Importing this module builds nothing.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

# kernel name -> source file under csrc/
SOURCES = {
    "nms": "nms.cu",
    "roi_align_fwd": "roi_align_fwd.cu",
    "roi_align_bwd": "roi_align_bwd.cu",
    "row_gather": "row_gather.cu",
    "row_gather_bulk": "row_gather_bulk.cu",
}

# -fmad=false: no FMA contraction, so the kernels round exactly like the plain
# versions' separate multiply and add (NMS compares IoU against a threshold
# and must agree bit for bit)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# kernel name -> launches made by its wrapper; one per wrapper call
LAUNCHES: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
            "kernels cannot be built")
    return path


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for part in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC_DIR, part), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns name -> ptxas report
    of each library compiled by this call. Raises if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names
            if not os.path.exists(library_path(n))}
    if not todo:
        return {}
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc rc={proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize does not report it)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
