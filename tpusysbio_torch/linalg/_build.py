"""Build and load the port's CUDA kernels (``linalg/csrc/*.cu``: the
Newton kernels of ``gpu_lu``, the mass-action derivatives of
``model/massaction.py`` and the BDF stepper's dense-output fold and step
controller of ``solvers/bdf.py``).

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
import re
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
_L = ctypes.c_longlong
_D = ctypes.c_double
# C entry points: name -> argument types; each returns a cudaError_t.
_SIGNATURES = {
    "tsb_gj_inverse_f32": (_P, _P, _I, _I, _P),
    "tsb_gj_inverse_major_f32": (_P, _P, _I, _I, _P),
    "tsb_gj_major_divide_check": (_P, _P, _P, _P, _I, _P),
    "tsb_refine_solve": (_P, _P, _P, _P, _I, _I, _P),
    "tsb_massaction_f32": (_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L,
                           _P, _I, _I, _P),
    "tsb_massaction_f64": (_I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _L,
                           _P, _I, _I, _P),
    "tsb_dense_fold": (_I, _I, _I, _I, _P, _L, _L, _P, _P, _P, _P, _P, _P,
                       _P, _P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P),
    "tsb_step_control": (_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _D, _D, _D, _D, _D, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                         _P, _P, _P),
}

_lib = None
build_info = {}   # filled by build(): path, seconds, compiler log


def sources(src_dir: Path = SRC_DIR):
    return sorted(Path(src_dir).glob("*.cu"))


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


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(src_dir: Path = SRC_DIR) -> Path:
    """Where the library of ``src_dir``'s sources is (or will be) built."""
    return BUILD_ROOT / _digest(sources(src_dir)) / LIB_NAME


def compile_library(src_dir: Path = SRC_DIR) -> dict:
    """Compile every ``*.cu`` of ``src_dir`` (if this version is not built
    yet) into one shared library. Returns ``path``, ``cached``, ``seconds``
    and, for a fresh build, the compiler's ``log``."""
    srcs = sources(src_dir)
    lib_path = library_path(src_dir)
    out_dir = lib_path.parent
    if lib_path.exists():
        return dict(path=str(lib_path), seconds=0.0, cached=True)
    nvcc = nvcc_path()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs, procs = [], []
        for src in srcs:
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
    return dict(path=str(lib_path), cached=False,
                seconds=time.perf_counter() - t0,
                log="".join(f"== {src.name}\n{out}" for src, out, _ in logs))


def build() -> Path:
    """Compile the port's sources (if this version is not built yet) and
    return the shared library's path."""
    build_info.update(compile_library())
    return Path(build_info["path"])


def resource_report(log: str) -> list:
    """What ``ptxas -v`` said in a build log, one entry per kernel: its
    source file, its (mangled) name, registers per thread, and the bytes of
    stack frame and of spill stores and loads (0 unless a loop was left
    rolled over an array that then lives in local memory)."""
    entries, src = [], None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        elif m := re.search(r"Compiling entry function '([^']+)'", line):
            entries.append(dict(source=src, kernel=m.group(1), registers=None,
                                stack=0, spill_stores=0, spill_loads=0))
        elif not entries:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", line):
            cur = entries[-1]
            for key, val in zip(("stack", "spill_stores", "spill_loads"),
                                m.groups()):
                cur[key] = max(cur[key], int(val))
        elif m := re.search(r"Used (\d+) registers", line):
            entries[-1]["registers"] = int(m.group(1))
    return entries


def open_library(path) -> ctypes.CDLL:
    """Load a library built by :func:`compile_library` and declare the
    entry points it has (a source set may lack some of them)."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def load() -> ctypes.CDLL:
    """The port's kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = open_library(build())
        missing = [name for name in _SIGNATURES if not hasattr(lib, name)]
        if missing:
            raise RuntimeError(f"the kernel library lacks {missing}")
        _lib = lib
    return _lib
