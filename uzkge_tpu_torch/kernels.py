"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc for sm_90a, one nvcc process per source,
all started together, and linked into one shared library with a plain C
interface, loaded with ctypes, at first use (never at import: the CPU test
suite imports every module on machines without nvcc or a card).  The library
lands in `uzkge_tpu_torch/build/`, which .gitignore lists.

Each C entry point enqueues its kernel on the stream it is given and returns
`cudaGetLastError()`.  The Python wrappers (ff/cuda_field.py,
ntt/cuda_ntt.py, msm/msm.py, msm/fixed_base.py) check their arguments,
allocate outputs with torch.empty, pass
`torch.cuda.current_stream().cuda_stream`, raise on a nonzero return, and
add one to their entry of LAUNCHES for every kernel launched (`count()`).
"""

import ctypes
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("ntt.cu", "msm.cu", "mont_mul.cu", "fixed_base.cu", "fixed_base_query.cu",
           "scan_reduce.cu")
HEADERS = ("field.cuh", "fixed_base.cuh", "fixed_base_query.cuh", "scan_reduce.cuh",
           "ntt.cuh", "msm.cuh", "launch.cuh")
ARCH = "arch=compute_90a,code=sm_90a"

# launch counts per kernel: plain integers, added to by count() and reset by
# reset_launches(), both under _COUNT_LOCK so that no thread's count is lost
LAUNCHES = {"ntt_pass": 0, "msm_bucket_accumulate": 0, "msm_bucket_reduce": 0,
            "fp_mont_mul": 0, "fb_bases": 0, "fb_mult_chunk": 0, "fq_batch_inv": 0,
            "fb_select": 0, "fb_pair_den": 0, "fb_pair_combine": 0, "fb_fold": 0,
            "scan_leaf_reduce": 0, "scan_proj_reduce": 0, "fp_mul_chain": 0}
# calls of each C entry point, one CUDA kernel launch each (fq_batch_inv's
# three kinds of launch apart): counted by launch(), reset by reset_launches();
# also the host library's g1_blind (native_host.py), one a commit's blinding
CALLS = {}
_COUNT_LOCK = threading.Lock()

_lib = None
_LIB_LOCK = threading.Lock()  # the first build and load, once for all threads

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # x, y, tw, pre, post, cst, out, S, IN, stream
    "ntt_pass_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # bx, by, std, buckets, idx, meta, extra, P, n, L, stream
    "msm_bucket_accumulate_launch": [_P] * 7 + [_I, _I, _I, _P],
    # n, L (not a launch: the accumulate's extra points a window)
    "msm_bucket_accumulate_extra": [_I, _I],
    # buckets, out, part, done, P, K, stream
    "msm_bucket_reduce_launch": [_P, _P, _P, _P, _I, _I, _P],
    # K (not a launch: the reduce's scratch points a window)
    "msm_bucket_reduce_parts": [_I],
    # a, b, out, N, field (0 = Fr, 1 = Fq), stream
    "fp_mont_mul_launch": [_P, _P, _P, _L, _I, _P],
    # a, b, out, N, iters, field, stream
    "fp_mul_chain_launch": [_P, _P, _P, _L, _I, _I, _P],
    # x, y, ox, oy, oz, n, W, c, stream
    "fb_bases_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # tx, ty, tz, bx, by, ox, oy, oz, fx, fy, fz, K, CH, stream
    "fb_mult_chunk_launch": [_P] * 11 + [_L, _I, _P],
    # the three kinds of launch of one fq_batch_inv: a, pref, prod, N, M,
    # stream; a, pref, out, N, M, stream; a, pref, pinv, out, N, M, stream
    "fq_inv_down_launch": [_P, _P, _P, _L, _L, _P],
    "fq_inv_root_launch": [_P, _P, _P, _L, _L, _P],
    "fq_inv_up_launch": [_P, _P, _P, _P, _L, _L, _P],
    # table, digits, x, y, inf, P, K, D, stream
    "fb_select_launch": [_P] * 5 + [_L, _L, _I, _P],
    # x, inf, den, flags, P, H, stream
    "fb_pair_den_launch": [_P] * 4 + [_L, _L, _P],
    # x, y, dinv, flags, xo, yo, info, P, H, stream
    "fb_pair_combine_launch": [_P] * 7 + [_L, _L, _P],
    # X, Y, Z, oX, oY, oZ, tiles, T, stream
    "fb_fold_launch": [_P] * 6 + [_L, _I, _P],
    # ax, ay, digits, ox, oy, oz, P, K, n, S, stream
    "scan_leaf_reduce_launch": [_P] * 6 + [_L, _L, _L, _I, _P],
    # X, Y, Z, oX, oY, oZ, lanes, S, stream
    "scan_proj_reduce_launch": [_P] * 6 + [_L, _I, _P],
}


def reset_launches():
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        CALLS.clear()


def count(name: str, counts: dict = LAUNCHES):
    """Add one to `counts[name]` (a kernel's LAUNCHES by default) under a
    lock shared by every thread."""
    with _COUNT_LOCK:
        counts[name] = counts.get(name, 0) + 1


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
    than every source; returns the library path.  One nvcc per source, all
    running at once, then one link."""
    so = os.path.join(BUILD_DIR, "libuzkge_kernels.so")
    srcs = [os.path.join(CSRC, s) for s in SOURCES]
    deps = srcs + [os.path.join(CSRC, h) for h in HEADERS]
    if os.path.exists(so) and os.path.getmtime(so) >= max(map(os.path.getmtime, deps)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    # object files unique per process and per thread
    nvcc, tag = _nvcc(), f"{os.getpid()}.{threading.get_ident()}"
    objs = [os.path.join(BUILD_DIR, f"{os.path.splitext(s)[0]}.{tag}.o") for s in SOURCES]
    procs = []
    for src, obj in zip(srcs, objs):
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-I", CSRC, "-c", "-o", obj, src]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    errors = []
    for src, proc in zip(SOURCES, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {src} failed ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(f"nvcc {src}:\n{err}")
    tmp = f"{so}.{tag}.tmp"
    try:
        if errors:
            raise RuntimeError("\n".join(errors))
        res = subprocess.run([nvcc, "-shared", "-o", tmp] + objs, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return so


def library():
    """The loaded kernel library (built on first call, by one thread while
    the others wait)."""
    global _lib
    if _lib is None:
        with _LIB_LOCK:
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
    count(name, CALLS)


def use_kernel(dev: torch.device, name: str) -> bool:
    """True for a CUDA device (the wrapper launches its kernel), False for the
    CPU (the wrapper runs the plain torch version); raises for any other."""
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {dev}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, shape, device):
    """Raise unless `t` is a contiguous int32 tensor of `shape` on `device`
    whose data starts on a 16-byte boundary (the kernels load elements as
    16-byte vectors)."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, want torch.int32")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data not 16-byte aligned")
