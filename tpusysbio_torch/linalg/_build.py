"""Build and load the port's CUDA kernels (``linalg/csrc/*.cu``).

Each source is compiled by its own ``nvcc`` process, all started together,
for ``sm_90a``; the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. The library goes to
``build/tpusysbio_torch_kernels/<hash of the sources and flags>/`` under the
repository root at first use, so a fresh checkout builds everything from
its own sources and an unchanged tree reuses the last build.

Importing this module needs no CUDA toolkit: nothing is compiled or loaded
until :func:`load` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "tpusysbio_torch_kernels")
LIB_NAME = "libtpusysbio_torch_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types; each returns a cudaError_t.
_SIGNATURES = {
    "tsb_gj_inverse_f32": (_P, _P, _I, _I, _P),
    "tsb_gj_inverse_major_f32": (_P, _P, _I, _I, _P),
    "tsb_refine_solve": (_P, _P, _P, _P, _I, _I, _P),
}

_lib = None
build_info = {}   # filled by build(): path, seconds, compiler log


def sources():
    return sorted(SRC_DIR.glob("*.cu"))


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources (if this version is not built yet) and return
    the shared library's path."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True)
        return lib_path
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        # wait for every compile before reporting a failure, so that no
        # nvcc outlives this call
        logs = [(src, proc.communicate()[0], proc.returncode)
                for src, proc in procs]
        for src, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp_lib, lib_path)
    build_info.update(path=str(lib_path), cached=False,
                      seconds=time.perf_counter() - t0,
                      log="".join(f"== {src.name}\n{out}"
                                  for src, out, _ in logs))
    return lib_path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
