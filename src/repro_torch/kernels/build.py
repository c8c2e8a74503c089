"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), compiled for
``sm_90a`` with ``-fmad=false`` — the quantizer must round exactly as the
reference does.  Libraries land in ``<repo>/build/kernels/`` under a name
that carries a hash of the source, the shared headers ``csrc/*.cuh`` and
the flags, so an edited source never loads a stale library.  All sources
compile in parallel, one ``nvcc`` each.
Nothing is built at import: the first CUDA call builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("quantize", "aggregate", "pack", "qmatmul", "sgd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_c = ctypes.c_void_p
_ll = ctypes.c_longlong
_f = ctypes.c_float
_i = ctypes.c_int
_u = ctypes.c_uint
#: C signature of every exported function (all return cudaError_t as int)
SIGNATURES = {
    "repro_quantize_codes": (_c, _c, _c, _ll, _f, _f, _i, _i, _c),
    "repro_dequantize_codes": (_c, _c, _ll, _f, _c),
    "repro_quantizer_plan": (_c, _c, _c, _ll, _c),
    "repro_masked_aggregate_f32": (_c, _c, _c, _c, _i, _ll, _f, _c),
    "repro_masked_aggregate_i32": (_c, _c, _c, _c, _i, _ll, _f, _c),
    "repro_masked_aggregate_plan": (_c, _c, _i, _ll, _i, _c),
    "repro_quantize_pack": (_c, _c, _c, _i, _ll, _ll, _i, _f, _f, _i, _i,
                            _c),
    "repro_pack_plan": (_i, _i, _ll, _ll, _i, _c),
    "repro_unpack_dequantize": (_c, _c, _i, _ll, _ll, _i, _u, _f, _c),
    "repro_quantize_pack_chunk": (_c, _c, _c, _c, _i, _ll, _i, _ll, _ll, _i,
                                  _u, _f, _f, _i, _i, _c),
    "repro_repack": (_c, _c, _i, _ll, _ll, _i, _i, _i, _i, _u, _c),
    "repro_pack_sums": (_c, _c, _i, _ll, _ll, _i, _u, _c),
    "repro_null_kernel": (_i, _c),
    "repro_qmatmul": (_c, _c, _c, _i, _i, _i, _i, _f, _c),
    "repro_qmatmul_plan": (_c, _c, _i, _i, _i, _i, _c),
    "repro_sgd_step_f32": (_c, _c, _ll, _ll, _ll, _ll, _f, _c),
    "repro_sgd_plan": (_c, _c, _ll, _ll, _ll, _ll, _c),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output (``-Xptxas -v``: registers, spills) per source, last build
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                           "the CUDA kernels cannot be built")
    return found


def _lib_path(name: str, flags: Tuple[str, ...] = NVCC_FLAGS) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _nvcc_proc(name: str, flags: Tuple[str, ...], tmp: Path) -> subprocess.Popen:
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
    return lib


def build_all() -> Dict[str, str]:
    """Build (where stale) and load every source; returns nvcc's output."""
    with _lock:
        todo = [n for n in SOURCES if n not in _libs]
        if not todo:
            return build_logs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs: Dict[str, Tuple[subprocess.Popen, Path, Path]] = {}
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (_nvcc_proc(name, NVCC_FLAGS, tmp), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for csrc/{name}.cu "
                              f"(exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            _libs[name] = _load(_lib_path(name))
        return build_logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _libs:
        build_all()
    return _libs[name]


def variant(name: str, *defines: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built with extra ``-D`` macros, for measurements
    that compare a kernel with a variant of itself (``tools/l2_probe.py``);
    the port's own calls go through ``library``."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    key = " ".join((name,) + defines)
    with _lock:
        if key not in _libs:
            out = _lib_path(name, flags)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                proc = _nvcc_proc(name, flags, tmp)
                log, _ = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed for csrc/{name}.cu with "
                                       f"{defines} (exit {proc.returncode}):\n{log}")
                os.replace(tmp, out)
            _libs[key] = _load(out)
        return _libs[key]
