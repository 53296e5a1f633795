"""Measures two forms of the device Montgomery product on one CUDA card:
field.cuh's fp_mul (a CIOS with 32 x 32 -> 64-bit products in C++, the one
the kernels use) and a PTX form of the same CIOS with carry chains
(mad.lo.cc / madc.hi.cc, below), and prints one JSON line.

    python3 uzkge_tpu_torch/product_forms.py

  1. products per second of each form: FP_CHAINS = 4 independent chains of
     512 products per thread, 2048 threads per SM, Fr and Fq, the two forms'
     outputs compared word for word;
  2. SASS instructions of one product in each form (cuobjdump -sass of a
     kernel that multiplies once, less the same kernel without the product);
  3. ntt_pass and fb_pair_combine built with each form (csrc/ copied with
     fp_mul's device path swapped for the PTX form) and timed at the shapes
     of the 52-card proof (kernel_times.py's), their outputs compared.
Builds go into uzkge_tpu_torch/build/product_forms/.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
OUT = os.path.join(_PKG, "build", "product_forms")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]

# The PTX form: one asm block per word b[i]; T in nine words (field.cuh's
# fp_mul comment says why nine suffice for both BN254 moduli).
PTX_FORM = r"""
template <class F>
__device__ __forceinline__ void fp_mul_ptx(uint32_t r[8], const uint32_t a[8],
                                           const uint32_t b[8]) {
  uint32_t t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0, t7 = 0, t8;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    asm("{\n\t.reg .u32 m;\n\t"
        "mad.lo.cc.u32 %0, %9, %17, %0;\n\tmadc.lo.cc.u32 %1, %10, %17, %1;\n\t"
        "madc.lo.cc.u32 %2, %11, %17, %2;\n\tmadc.lo.cc.u32 %3, %12, %17, %3;\n\t"
        "madc.lo.cc.u32 %4, %13, %17, %4;\n\tmadc.lo.cc.u32 %5, %14, %17, %5;\n\t"
        "madc.lo.cc.u32 %6, %15, %17, %6;\n\tmadc.lo.cc.u32 %7, %16, %17, %7;\n\t"
        "addc.u32 %8, 0, 0;\n\t"
        "mad.hi.cc.u32 %1, %9, %17, %1;\n\tmadc.hi.cc.u32 %2, %10, %17, %2;\n\t"
        "madc.hi.cc.u32 %3, %11, %17, %3;\n\tmadc.hi.cc.u32 %4, %12, %17, %4;\n\t"
        "madc.hi.cc.u32 %5, %13, %17, %5;\n\tmadc.hi.cc.u32 %6, %14, %17, %6;\n\t"
        "madc.hi.cc.u32 %7, %15, %17, %7;\n\tmadc.hi.u32 %8, %16, %17, %8;\n\t"
        "mul.lo.u32 m, %0, %18;\n\t"
        "mad.lo.cc.u32 %0, m, %19, %0;\n\tmadc.lo.cc.u32 %1, m, %20, %1;\n\t"
        "madc.lo.cc.u32 %2, m, %21, %2;\n\tmadc.lo.cc.u32 %3, m, %22, %3;\n\t"
        "madc.lo.cc.u32 %4, m, %23, %4;\n\tmadc.lo.cc.u32 %5, m, %24, %5;\n\t"
        "madc.lo.cc.u32 %6, m, %25, %6;\n\tmadc.lo.cc.u32 %7, m, %26, %7;\n\t"
        "addc.u32 %8, %8, 0;\n\t"
        "mad.hi.cc.u32 %1, m, %19, %1;\n\tmadc.hi.cc.u32 %2, m, %20, %2;\n\t"
        "madc.hi.cc.u32 %3, m, %21, %3;\n\tmadc.hi.cc.u32 %4, m, %22, %4;\n\t"
        "madc.hi.cc.u32 %5, m, %23, %5;\n\tmadc.hi.cc.u32 %6, m, %24, %6;\n\t"
        "madc.hi.cc.u32 %7, m, %25, %7;\n\tmadc.hi.u32 %8, m, %26, %8;\n\t}"
        : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7),
          "=r"(t8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
          "r"(a[7]), "r"(b[i]), "r"(F::inv()), "r"(F::p(0)), "r"(F::p(1)), "r"(F::p(2)),
          "r"(F::p(3)), "r"(F::p(4)), "r"(F::p(5)), "r"(F::p(6)), "r"(F::p(7)));
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = t7; t7 = t8;
  }
  const uint32_t t[8] = {t0, t1, t2, t3, t4, t5, t6, t7};
  fp_reduce_once<F>(r, t, 0);
}
"""

BENCH = r"""
#include <cstdio>
#include <cstdlib>
#include <cuda_runtime.h>
#include "field.cuh"
""" + PTX_FORM + r"""
template <class F, int FORM>
__device__ __forceinline__ void mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  if (FORM == 0) fp_mul<F>(r, a, b); else fp_mul_ptx<F>(r, a, b);
}
template <class F, int FORM>
__global__ void __launch_bounds__(256) chain(const uint32_t *a, const uint32_t *b, uint32_t *out,
                                             int N, int iters) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  uint32_t acc[4][8], y[8];
  for (int k = 0; k < 4; k++) for (int j = 0; j < 8; j++) acc[k][j] = a[((size_t)k * N + i) * 8 + j];
  for (int j = 0; j < 8; j++) y[j] = b[(size_t)i * 8 + j];
  for (int it = 0; it < iters; it++) {
#pragma unroll
    for (int k = 0; k < 4; k++) mul<F, FORM>(acc[k], acc[k], y);
  }
  for (int k = 0; k < 4; k++) for (int j = 0; j < 8; j++) out[((size_t)k * N + i) * 8 + j] = acc[k][j];
}
template <int FORM> __global__ void one(const uint32_t *a, const uint32_t *b, uint32_t *out) {
  uint32_t x[8], y[8];
  for (int j = 0; j < 8; j++) { x[j] = a[j]; y[j] = b[j]; }
  mul<Fr, FORM>(x, x, y);
  for (int j = 0; j < 8; j++) out[j] = x[j];
}
__global__ void none(const uint32_t *a, const uint32_t *b, uint32_t *out) {
  for (int j = 0; j < 8; j++) out[j] = a[j] ^ b[j];
}
template __global__ void one<0>(const uint32_t *, const uint32_t *, uint32_t *);
template __global__ void one<1>(const uint32_t *, const uint32_t *, uint32_t *);

template <class F, int FORM> void launch(const uint32_t *a, const uint32_t *b, uint32_t *o, int N, int it) {
  chain<F, FORM><<<N / 256, 256>>>(a, b, o, N, it);
}
int main() {
  int sms; cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int N = sms * 2048, iters = 512;
  size_t na = (size_t)4 * N * 8, nb = (size_t)N * 8;
  uint32_t *ha = (uint32_t *)malloc(na * 4), *hb = (uint32_t *)malloc(nb * 4);
  srand(7);  // canonical values: top limb below 2^28 < both moduli's
  for (size_t i = 0; i < na; i++) ha[i] = (i & 7) == 7 ? (rand() & 0x0fffffff) : (uint32_t)rand() * 2654435761u;
  for (size_t i = 0; i < nb; i++) hb[i] = (i & 7) == 7 ? (rand() & 0x0fffffff) : (uint32_t)rand() * 2246822519u;
  uint32_t *a, *b, *o[2][2];
  cudaMalloc(&a, na * 4); cudaMalloc(&b, nb * 4);
  for (int f = 0; f < 2; f++) for (int g = 0; g < 2; g++) cudaMalloc(&o[f][g], na * 4);
  cudaMemcpy(a, ha, na * 4, cudaMemcpyHostToDevice); cudaMemcpy(b, hb, nb * 4, cudaMemcpyHostToDevice);
  cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
  printf("{\"threads\": %d, \"chains\": 4, \"iters\": %d, \"runs\": [", N, iters);
  for (int rep = 0; rep < 2; rep++)
    for (int f = 0; f < 2; f++)
      for (int field = 0; field < 2; field++) {
        auto run = [&]() {
          if (field == 0) (f ? launch<Fr, 1> : launch<Fr, 0>)(a, b, o[f][field], N, iters);
          else (f ? launch<Fq, 1> : launch<Fq, 0>)(a, b, o[f][field], N, iters);
        };
        run();
        cudaEventRecord(e0); run(); run(); run(); cudaEventRecord(e1); cudaEventSynchronize(e1);
        float ms; cudaEventElapsedTime(&ms, e0, e1); ms /= 3;
        printf("%s{\"form\": \"%s\", \"field\": \"%s\", \"ms\": %.6f, \"products_per_s\": %.6e}",
               rep || f || field ? ", " : "", f ? "ptx" : "cxx", field ? "Fq" : "Fr", ms,
               (double)N * 4 * iters / (ms * 1e-3));
      }
  size_t bad = 0;
  uint32_t *h0 = (uint32_t *)malloc(na * 4), *h1 = (uint32_t *)malloc(na * 4);
  for (int field = 0; field < 2; field++) {
    cudaMemcpy(h0, o[0][field], na * 4, cudaMemcpyDeviceToHost);
    cudaMemcpy(h1, o[1][field], na * 4, cudaMemcpyDeviceToHost);
    for (size_t i = 0; i < na; i++) bad += h0[i] != h1[i];
  }
  printf("], \"words_differing\": %zu, \"cuda\": \"%s\"}\n", bad,
         cudaGetErrorString(cudaDeviceSynchronize()));
  return 0;
}
"""


def _run(cmd, **kw):
    res = subprocess.run(cmd, capture_output=True, text=True, **kw)
    if res.returncode:
        raise RuntimeError(f"{cmd[0]} failed ({res.returncode}):\n{res.stderr[-4000:]}")
    return res.stdout


def sass_counts(cubin: str) -> dict:
    """Instructions (NOPs left out) of each kernel in a cubin."""
    counts, fn = {}, None
    sass = _run([os.path.join(os.path.dirname(NVCC), "cuobjdump"), "-sass", cubin])
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?P\d\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn and not m.group(1).startswith("NOP"):
            counts[fn] += 1
    return counts


def ptx_csrc(dst: str) -> str:
    """csrc/ copied to `dst` with fp_mul's device path swapped for the PTX form."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    path = os.path.join(dst, "field.cuh")
    with open(path) as f:
        src = f.read()
    head = "template <class F>\nZK_HD void fp_mul("
    if src.count(head) != 1:
        raise RuntimeError("field.cuh: fp_mul's definition not found")
    src = src.replace(head, "template <class F>\nZK_HD void fp_mul_cxx(")
    src = src.replace("ZK_HD void fp_copy", "#ifdef __CUDACC__\n" + PTX_FORM + "#endif\n"
                      "template <class F>\nZK_HD void fp_mul(uint32_t r[8], const uint32_t a[8], "
                      "const uint32_t b[8]) {\n#ifdef __CUDA_ARCH__\n  fp_mul_ptx<F>(r, a, b);\n"
                      "#else\n  fp_mul_cxx<F>(r, a, b);\n#endif\n}\n\nZK_HD void fp_copy", 1)
    with open(path, "w") as f:
        f.write(src)
    return dst


def kernel_libs():
    """{form: (ntt lib, query lib)}, built in parallel."""
    dirs = {"cxx": CSRC, "ptx": ptx_csrc(os.path.join(OUT, "csrc_ptx"))}
    procs = {}
    for form, d in dirs.items():
        for src in ("ntt.cu", "fixed_base_query.cu"):
            so = os.path.join(OUT, f"{form}_{src[:-3]}.so")
            cmd = [NVCC, *ARCH, "-shared", "-Xcompiler", "-fPIC", "-I", d, "-o", so,
                   os.path.join(d, src)]
            procs[form, src] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.PIPE, text=True))
    libs = {}
    for (form, src), (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc {form} {src}:\n{err[-4000:]}")
        lib = ctypes.CDLL(so)
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        if src == "ntt.cu":
            lib.ntt_pass_launch.argtypes = [P] * 6 + [I] * 3 + [P]
        else:
            lib.fb_pair_combine_launch.argtypes = [P] * 7 + [L, L, P]
        libs.setdefault(form, {})[src] = lib
    return libs


def time_kernels(libs):
    """Per-proof ms of ntt_pass and fb_pair_combine under each form, in
    turns (cxx, ptx, ptx, cxx: each shape's mean of the two), outputs equal."""
    import torch

    sys.path.insert(0, os.path.dirname(_PKG))
    from uzkge_tpu_torch.kernel_times import LEVELS, NTT_SHAPES, QUERY_BATCHES, cuda_ms, rand
    from uzkge_tpu_torch.ntt.ntt import NTTDomain
    from uzkge_tpu_torch.ntt.stockham import stage_twiddles_strided

    dev = torch.device("cuda:0")
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()

    def ms(fn):
        return cuda_ms(fn, 20)

    tot = {(k, f): 0.0 for k in ("ntt_pass", "fb_pair_combine") for f in ("cxx", "ptx")}
    master = NTTDomain(2048, dev).master
    for (OUT_, S, IN, pre, post, const), count in NTT_SHAPES.items():
        x = rand(dev, OUT_, S, IN)
        tw = stage_twiddles_strided(master, 2048, S, 2048 // S, False)[0]
        lads = (rand(dev, S, IN) if pre else None, rand(dev, S, IN) if post else None,
                rand(dev) if const else None)
        ys = {}
        for form in ("cxx", "ptx", "ptx", "cxx"):
            y = ys.setdefault(form, torch.empty_like(x))
            lib = libs[form]["ntt.cu"]
            tot["ntt_pass", form] += count / 2 * ms(lambda: lib.ntt_pass_launch(
                ptr(x), ptr(y), ptr(tw), *map(ptr, lads), OUT_, S, IN, stream))
        if not torch.equal(ys["cxx"], ys["ptx"]):
            raise AssertionError(f"ntt_pass {OUT_, S, IN}: the two forms disagree")
    for P in QUERY_BATCHES:
        for H in LEVELS:
            x, y, dinv = rand(dev, P, 2 * H), rand(dev, P, 2 * H), rand(dev, P, H)
            flags = torch.randint(0, 8, (P, H), dtype=torch.int32, device=dev)
            outs = {}
            for form in ("cxx", "ptx", "ptx", "cxx"):
                xo, yo, info = outs.setdefault(form, (torch.empty_like(dinv), torch.empty_like(dinv),
                                                      torch.empty_like(flags)))
                lib = libs[form]["fixed_base_query.cu"]
                tot["fb_pair_combine", form] += ms(lambda: lib.fb_pair_combine_launch(
                    ptr(x), ptr(y), ptr(dinv), ptr(flags), ptr(xo), ptr(yo), ptr(info), P, H,
                    stream)) / 2
            if not all(torch.equal(a, b) for a, b in zip(outs["cxx"], outs["ptx"])):
                raise AssertionError(f"fb_pair_combine P={P} H={H}: the two forms disagree")
    return {f"{k}_per_proof_ms_{f}": v for (k, f), v in tot.items()}


NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def main():
    os.makedirs(OUT, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    src = os.path.join(OUT, "bench.cu")
    with open(src, "w") as f:
        f.write(BENCH)
    exe, cubin = os.path.join(OUT, "bench"), os.path.join(OUT, "bench.cubin")
    _run([NVCC, *ARCH, "-I", CSRC, "-o", exe, src])
    _run([NVCC, *ARCH, "-I", CSRC, "-cubin", "-o", cubin, src])
    out = {"card": card, "rate": json.loads(_run([exe]))}
    counts = sass_counts(cubin)
    base = next(v for k, v in counts.items() if "none" in k)
    out["sass_per_product"] = {form: next(v for k, v in counts.items() if f"oneILi{i}E" in k) - base
                               for i, form in enumerate(("cxx", "ptx"))}
    out.update(time_kernels(kernel_libs()))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
