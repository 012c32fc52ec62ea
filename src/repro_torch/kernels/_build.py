"""Build and load the CUDA kernels of this package.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source, all started together; the objects are linked into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use (never at import), lands in ``kernels/_build/`` (listed in
``.gitignore``) under a name that hashes the sources and flags, and is
reused while both are unchanged.  A failed build raises with nvcc's output.
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
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("stencil5.cu", "spmv_bell.cu", "solve_step.cu", "supernode.cu",
           "flash_attention.cu")
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v"]
# per-source extra flags: the panel kernels keep the reference's rounding
# of every a - b*c (no contraction into an FMA)
SOURCE_FLAGS = {"supernode.cu": ["-fmad=false"]}

#: seconds the last build took (None when the library came from the cache)
LAST_BUILD_SECONDS = None
#: nvcc's combined output of the last build (ptxas register/spill report)
BUILD_LOG = ""

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_LP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)

_SIGNATURES = {
    "stencil5_f32": [_P, _P, _P, _I, _I, _P],
    "stencil5_f64": [_P, _P, _P, _I, _I, _P],
    "stencil5_lanes_f32": [_P, _P, _P, _I, _I, _I, _L, _P],
    "stencil5_lanes_f64": [_P, _P, _P, _I, _I, _I, _L, _P],
    "bell_spmv_f32": [_P, _P, _P, _P, _P, _L, _P],
    "bell_spmv_f64": [_P, _P, _P, _P, _P, _L, _P],
    "bell_spmv_lanes_f32": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _P],
    "bell_spmv_lanes_f64": [_P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _P],
    "fused_step": [_I, _I, _PP, _PP, _PP, _LP, _IP, _P, _P, _P, _L, _I, _I,
                   _P],
    # the supernodal kernels take nl value lanes: C's lane stride ldc (and
    # y's, ldy) and the lane count nl after the factor vector
    "sn_panel_factor": [_I, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _I, _I, _I, _I, _P],
    "sn_schur_update": [_I, _P, _L, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _P],
    "sn_sweep": [_I, _I, _I, _P, _L, _P, _L, _I, _P, _P, _P, _P, _P, _P, _P,
                 _P, _I, _I, _I, _I, _P],
    # ... B, H, K, S, T, d, causal, window (, rows, heads), stream
    "flash_attention_f32": [_P, _P, _P, _P, _LP, _I, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P],
    "flash_attention_bf16": [_P, _P, _P, _P, _LP, _I, _I, _I, _I, _I, _I,
                             _I, _I, _P],
    "flash_attention_smem": [_I, _I, _I],
}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME/bin``, ``PATH``, or the
    toolkit's default install location)."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(repr(sorted(SOURCE_FLAGS.items())).encode())
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the kernels library."""
    global LAST_BUILD_SECONDS, BUILD_LOG
    so = BUILD_DIR / f"libreprotorch_{_digest()}.so"
    if so.exists():
        LAST_BUILD_SECONDS = None
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = os.path.join(tmp, src.replace(".cu", ".o"))
            objs.append(obj)
            procs.append(subprocess.Popen(
                [compiler, *FLAGS, *SOURCE_FLAGS.get(src, ()), "-c",
                 str(CSRC / src), "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs, failed = [], []
        for src, p in zip(SOURCES, procs):
            out, _ = p.communicate()
            logs.append(f"== nvcc {src} (rc={p.returncode})\n{out}")
            if p.returncode != 0:
                failed.append(src)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(
                f"nvcc failed on {', '.join(failed)}:\n{BUILD_LOG}")
        tmp_so = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [compiler, *ARCH, "-shared", *objs, "-o", tmp_so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        BUILD_LOG += f"\n== link (rc={link.returncode})\n{link.stdout}"
        if link.returncode != 0:
            raise RuntimeError(f"linking the kernels failed:\n{BUILD_LOG}")
        os.replace(tmp_so, so)
    LAST_BUILD_SECONDS = time.perf_counter() - t0
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernels library (built at first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer value."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


_DTYPE_TAGS = {"float32": "f32", "float64": "f64", "bfloat16": "bf16"}


def cuda_dtype_tag(dtype, allowed=("f32", "f64")) -> str:
    """The entry-point suffix of ``dtype`` (``f32``/``f64``/``bf16``);
    raises unless it is one of the kernel's ``allowed`` tags."""
    tag = _DTYPE_TAGS.get(str(dtype).removeprefix("torch."))
    if tag not in allowed:
        names = [k for k, v in _DTYPE_TAGS.items() if v in allowed]
        raise TypeError(f"this CUDA kernel takes {' or '.join(names)}, "
                        f"got {dtype}")
    return tag
