"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc for sm_90a into one shared library with a
plain C interface, loaded with ctypes, at first use (never at import: the
CPU test suite imports every module on machines without nvcc or a card).
The library lands in `uzkge_tpu_torch/build/`, which .gitignore lists.

Each C entry point enqueues one kernel on the stream it is given and returns
`cudaGetLastError()`.  The Python wrappers (ntt/cuda_ntt.py, msm/msm.py)
check their arguments, allocate outputs with torch.empty, pass
`torch.cuda.current_stream().cuda_stream`, raise on a nonzero return, and
add one to their entry of LAUNCHES for every kernel launched.
"""

import ctypes
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("ntt.cu", "msm.cu")
HEADERS = ("field.cuh",)
ARCH = "arch=compute_90a,code=sm_90a"

# launch counts per kernel: plain integers, reset by reset_launches()
LAUNCHES = {"ntt_pass": 0, "msm_bucket_accumulate": 0, "msm_bucket_reduce": 0}

_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # x, y, tw, pre, post, cst, out, S, IN, stream
    "ntt_pass_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # bx, by, std, buckets, P, n, K, stream
    "msm_bucket_accumulate_launch": [_P, _P, _P, _P, _I, _I, _I, _P],
    # buckets, out, P, K, stream
    "msm_bucket_reduce_launch": [_P, _P, _I, _I, _P],
}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into build/libuzkge_kernels.so unless it is newer
    than every source; returns the library path."""
    so = os.path.join(BUILD_DIR, "libuzkge_kernels.so")
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    if os.path.exists(so) and os.path.getmtime(so) >= max(map(os.path.getmtime, deps)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-I", CSRC, "-o", tmp] + srcs
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr)
    os.replace(tmp, so)
    return so


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, *args):
    """Call the C entry point `name`; raise if it reports a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, shape, device):
    """Raise unless `t` is a contiguous int32 tensor of `shape` on `device`."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
