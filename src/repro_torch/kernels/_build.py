"""Build the CUDA kernels of ``csrc/`` into one shared library and load it.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process per
source, all started together), linked into one ``.so`` with a plain C
interface, and loaded with :mod:`ctypes`.  The build happens at first use,
into ``build/repro_torch_kernels/<hash>/`` at the repository root, where the
hash covers the sources and the flags; a later process with the same
sources loads the library without compiling.

The library links against the CUDA runtime only: no kernel uses a TMA
tensor map, so nothing reaches the driver API (no ``-lcuda``; the wgmma
kernel of ``flash_attention.cu`` is fed by ``cp.async``).
``tests/test_torch_build.py`` holds ``_SIGNATURES`` to the sources'
``extern "C"`` functions.

Nothing here runs at import: the CPU tests import every module, and a
machine without CUDA has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()
#: seconds the last build in this process took (0.0 when the library was
#: already built on disk); the compiler output goes to build.log beside it
last_build = {"seconds": 0.0}

_I64 = ctypes.c_longlong
_PTR = ctypes.c_void_p
_SIGNATURES = {
    "repro_cuda_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "repro_bincount_tiles_group": ([_I64, _I64, _I64], ctypes.c_int),
    "repro_bincount_tiles_scratch_bytes": ([_I64, _I64, _I64], _I64),
    "repro_bincount_tiles": ([_PTR, _I64, _I64, _I64, _PTR, _PTR, _PTR, _PTR,
                              _PTR], ctypes.c_int),
    "repro_bitonic_smem_width": ([], _I64),
    "repro_bitonic_sort": ([_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I64, _I64,
                            _I64, ctypes.c_int, _PTR], ctypes.c_int),
    "repro_flash_attention": ([_PTR, _PTR, _PTR, _PTR, _I64, _I64, _I64, _I64,
                               _I64, _I64, ctypes.c_int, ctypes.c_int,
                               ctypes.c_float, _PTR], ctypes.c_int),
    "repro_flash_attention_route": ([_I64, ctypes.c_int], ctypes.c_int),
    "repro_ssm_scan": ([_PTR, _PTR, _PTR, _I64, _I64, _I64, ctypes.c_int,
                        ctypes.c_int, _PTR], ctypes.c_int),
    "repro_prefix_scan_scratch_bytes": ([_I64, _I64, ctypes.c_int], _I64),
    "repro_prefix_scan": ([_PTR, _PTR, _I64, _I64, ctypes.c_int, ctypes.c_int,
                           _PTR, _PTR], ctypes.c_int),
    "repro_bincount": ([_PTR, _I64, _I64, _PTR, _PTR], ctypes.c_int),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels of repro_torch are built with it")


def sources():
    """The CUDA sources every build compiles, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile and link the library unless this source hash is built."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix=".tmp-", dir=BUILD_ROOT))
    try:
        t0 = time.perf_counter()
        procs = []
        for src in sources():
            obj = tmp / (src.stem + ".o")
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        failed = []
        for src, p in procs:
            out, _ = p.communicate()
            log.append(f"== {src.name} (exit {p.returncode})\n{out}")
            if p.returncode:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed) + ":\n"
                               + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(tmp / (s.stem + ".o")) for s in sources()]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        if link.returncode:
            raise RuntimeError("linking the CUDA kernels failed:\n"
                               + link.stdout)
        last_build["seconds"] = time.perf_counter() - t0
        try:
            os.replace(tmp, out_dir)
        except OSError:
            if not lib_path.exists():    # not a concurrent build that won
                raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (args, res) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = res
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
