"""Build and load the port's CUDA kernels.

Every ``*.cu`` under ``kernels/csrc/`` is compiled on first use with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <lib> <source>

(one nvcc per source, all started together; the shared ``*.cuh`` headers
are included by the sources) into ``build/kernels/`` at the repository
root, named by a hash of the source, the headers and the flags, and loaded with
``ctypes``.  A library whose hash already exists is loaded without a build.
Nothing is built when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(src: pathlib.Path) -> pathlib.Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel; returns
    {source stem: library path}.  Raises with nvcc's output on failure."""
    sources = sorted(CSRC.glob("*.cu"))
    out = {s.stem: _lib_path(s) for s in sources}
    todo = [s for s in sources if not out[s.stem].exists()]
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for s in todo:
        tmp = out[s.stem].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for s, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {s.name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[s.stem])      # atomic: concurrent builds agree
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on demand)."""
    if stem not in _LIBS:
        _LIBS[stem] = ctypes.CDLL(str(build_all()[stem]))
    return _LIBS[stem]
