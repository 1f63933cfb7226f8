"""Build and load the port's hand-written CUDA kernels (nvcc + ctypes).

Every ``csrc/*.cu`` file is compiled for Hopper (``sm_90a``) into an
object file, one ``nvcc`` process per source, all started together; the
objects are then linked into ONE shared library with a plain C interface,
loaded with ``ctypes``.  Pointers and the CUDA stream cross as
``c_void_p``; every launch function returns its ``cudaGetLastError()``
code, which the Python wrapper checks.

The library is cached under ``build/kernels/<hash>/`` at the root of the
checkout, keyed by a hash of the source files alone: editing a source
rebuilds, nothing else does.  A failed build raises with nvcc's output.
Nothing is built or imported until a kernel is first launched, so the
package imports on hosts without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
LIB_NAME = "librepro_torch_kernels.so"

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message carries its output."""


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels can only be built on a host with the CUDA toolkit")


def _run_all(cmds: list) -> None:
    """Run every command at once; raise with the output of any failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    errors = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"$ {' '.join(cmd)}\n{out}")
    if errors:
        raise KernelBuildError("nvcc failed:\n" + "\n".join(errors))


def build() -> pathlib.Path:
    """Compile the sources if their hash has no library yet; its path."""
    out_dir = BUILD_ROOT / source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs, cmds = [], []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(str(obj))
            cmds.append([nvcc, *ARCH_FLAGS, *NVCC_FLAGS,
                         "-c", str(src), "-o", str(obj)])
        _run_all(cmds)
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", *objs, "-o", str(tmp_lib)]])
        os.replace(tmp_lib, lib_path)      # atomic: concurrent builds agree
    return lib_path


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, nnz, xor, bh, tq, tk, kv_len, d, patch, sm_scale,
    # threshold, stream
    "launch_pssa_attention": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _F, _F, _P],
    # q, k, v, out, cas, bh, tq, tk, d, cls_index, sm_denom, stream
    "launch_cross_attention_tips": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _F, _P],
    # hi, lo, w, prec, out, m, k, n, dataflow, stream
    "launch_bitslice_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, ref, out, rows, w, vec4, stream
    "launch_patch_delta": [_P, _P, _P, _I, _I, _I, _P],
    # sas, packed, counts, rows, tk, patch, threshold, stream
    "launch_patch_bitmap": [_P, _P, _P, _I, _I, _I, _F, _P],
    # x, dA, B, C, y, state, bh, t, p, n, chunk, heads, stream
    "launch_ssd_scan": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
}


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch function reported a CUDA error."""
    if err != 0:
        what = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: error {err} "
                           f"({what})")
