"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file compiles with its own ``nvcc`` process, all
started together (``csrc/*.cuh`` holds code that two of them share),
and the objects link into one shared library with a plain C interface,
which is loaded with ``ctypes``. The library
lands under ``build/torch_kernels/`` at the repository root, named by a
hash of the sources and flags, so an edit rebuilds and an unchanged
tree reuses the file. Nothing here runs at import time: the first call
of :func:`lib` builds.

Flags: ``-fmad=false`` and no ``--use_fast_math``, because the kernels
round every product and sum on its own to stay bit-identical to their
plain PyTorch versions (the tensor-core forms, K7's ``mma`` and K6's, sum
in the tensor cores' order and are held to bars of their own; K7's SiLU calls the fast exp and division intrinsics by
name; K8 calls ``fmaf`` by name where XLA fuses a multiply-add).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
MAX_SMEM = 227 * 1024  # dynamic shared memory one Hopper block can use
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)  # a host array of ints
_LP = ctypes.POINTER(ctypes.c_longlong)  # a host array of 64-bit ints
_VP = ctypes.POINTER(ctypes.c_void_p)  # a host array of pointers
# C entry point -> argtypes; every pointer and the stream are c_void_p so
# ctypes passes them as 64-bit values
_SIGNATURES = {
    "ssyt_lk_pyramid": (_VP, _VP, _LP, _P, _P, _I, _I, _IP, _P),
    "ssyt_lk_pyramid_smem_bytes": (_I, _IP),
    "ssyt_lk_pyramid_cluster": (),
    "ssyt_lk_pyramid_max_clusters": (_I, _IP),
    "ssyt_letterbox_u8": (_P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _F, _P),
    "ssyt_nms_keep": (_P, _P, _P, _I, _I, _F, _F, _P),
    "ssyt_nms_keep_cluster": (),
    "ssyt_auction_smem_bytes": (_I, _I, _I),
    "ssyt_auction": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "ssyt_banded_crop": (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _P),
    "ssyt_os_stage_smem_bytes": (_I, _I, _I, _I, _I, _I, _I),
    "ssyt_os_stage_form": (_I, _I, _I, _I, _I, _I, _I),
    "ssyt_os_stage": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P),
    "ssyt_conv_act": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *(_L,) * 8,
                      _I, _I, _I, _I, _I, _P),
    "ssyt_conv_im2col_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *(_L,) * 8,
                             _I, _I, _I, _I, _I, _P),
    "ssyt_conv_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, *(_L,) * 8,
                      _I, _I, _I, _I, _I, _P),
    "ssyt_conv_s8": (*(_P,) * 7, *(_I,) * 7, *(_L,) * 8, *(_I,) * 10, _P),
    "ssyt_conv_s8_dw": (*(_P,) * 6, *(_I,) * 6, *(_L,) * 8, *(_I,) * 9, _P),
    "ssyt_conv_s8_quantize": (_P, _P, _P, _I, _I, _I, _I, *(_L,) * 4, _I, _I,
                              _P),
}

# byte counts; the other entry points return a CUDA error code
_RESTYPES = {"ssyt_auction_smem_bytes": _L, "ssyt_os_stage_smem_bytes": _L,
             "ssyt_lk_pyramid_smem_bytes": _L}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of this process's build
compile_seconds: dict[str, float] = {}  # per source, of this process's build


def _sources() -> list[str]:
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cu")
    )


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
            "kernels of strongsort_yolo_tpu_torch build on first use"
        )
    return found


def lib_path() -> str:
    """Where the library of the current sources and flags is built."""
    return _lib_path(_sources())


def _lib_path(sources: list[str]) -> str:
    """Named by a hash of the sources, the headers beside them and the
    flags."""
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    h = hashlib.sha256()
    for path in sources + headers:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libssyt_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> float:
    """Run ``cmd``; -> its wall time in seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return time.perf_counter() - t0


def _compile(sources: list[str], out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    # build in a private directory, then rename the library: a concurrent
    # process never loads a half-written file
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(src) + ".o")
                for src in sources]
        with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
            futs = {os.path.basename(s): pool.submit(
                _run, [nvcc, *NVCC_FLAGS, "-c", "-o", o, s])
                for s, o in zip(sources, objs)}
            for name, fut in futs.items():
                compile_seconds[name] = fut.result()
        lib_tmp = os.path.join(tmp, "lib.so")
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs])
        os.replace(lib_tmp, out)


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        sources = _sources()
        path = _lib_path(sources)
        if not os.path.exists(path):
            t0 = time.perf_counter()
            _compile(sources, path)
            build_seconds = time.perf_counter() - t0
        cdll = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = list(argtypes)
            fn.restype = _RESTYPES.get(name, ctypes.c_int)
        cdll.ssyt_error_string.argtypes = [ctypes.c_int]
        cdll.ssyt_error_string.restype = ctypes.c_char_p
        _lib = cdll
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        text = lib().ssyt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({text}) at launch")
