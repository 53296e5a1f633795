"""The Pippenger's own arithmetic (uzkge_tpu_torch/csrc/msm.cuh), compiled with
g++: msm_bucket_reduce's blocks against the port's plain reduce and host
scalar arithmetic, and the accumulate's sort, pieces and merge against the
port's plain accumulate (limb for limb) and, through the reduce, against the
JAX package's msm and the host Pippenger (affine points).

The kernel's block functions run on the host with each block's threads in
turn (msm_reduce_group for every block of a window, then msm_window_sum, as
the window's last block runs it on the card) at P = 1 and 2, K = 1, 3 and
4, at every slicing T = 1, 2, 4, 8 (8 .. 1 blocks of 256 threads a window:
T = 8 puts 8 slices of a bucket, some empty, in one block and the window's
upper bucket bits on the block index).  Every bucket is a multiple of the
generator with a known scalar, scaled projectively by a seeded z: some are
the identity (some chunks wholly), and bucket 0 holds a point that must be
ignored.  The window sums are compared as affine points with
msm_bucket_reduce_plain's and with sum_b b * (sum_k e_kb) * G from the
scalars.

The accumulate runs every window's sort block with its 1024 threads in turn,
then every piece, then every level of the merge's binary tree, at n = 1024,
P = 3 and the piece length the port picks there (L = 2: many pieces, deep
trees) and at L = 7, on rows of five kinds: dense, an all-zero
row among dense ones, all ones (every point in bucket 1 of window 0: 512
pieces, a tree nine deep), values below 2^16 (two windows used) and one
scalar repeated at every point.  Inputs come from
numpy with fixed seeds; JAX is imported inside the test that uses it.
"""

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.msm import msm as tm

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "uzkge_tpu_torch", "csrc")

_HARNESS = r"""
#include "msm.cuh"
// a block on the host: its threads run in turn between barriers
struct SerialBlock {
  int B;
  G1Proj *r;
  template <class F> void each(F f) { for (int t = 0; t < B; t++) f(t, r[t]); }
  void sync() {}
};
extern "C" {
int msm_slices(int K) { return msm_reduce_slices(K); }
// msm_bucket_accumulate over P * 32 windows at piece length L: each window's
// sort block, then every piece slot of every window, then each merge level
void msm_acc_n(const uint32_t *bx, const uint32_t *by, const uint8_t *std_bytes,
               uint32_t *buckets, int P, int n, int L) {
  const int XS = (n + L - 1) / L, slots = XS + MSM_BUCKETS - 1;
  int32_t *idx = new int32_t[(size_t)P * MSM_WINDOWS * n];
  int32_t *meta = new int32_t[(size_t)P * MSM_WINDOWS * ACC_META_INTS];
  uint32_t *extra = new uint32_t[(size_t)P * MSM_WINDOWS * XS * MSM_PT];
  G1Proj *r = new G1Proj[ACC_SORT_THREADS];
  int *sh = new int[ACC_SORT_SHARED];
  SerialBlock blk{ACC_SORT_THREADS, r};
  for (int pw = 0; pw < P * MSM_WINDOWS; pw++)
    msm_acc_sort(blk, std_bytes, idx, meta, buckets, sh, pw, n, L);
  for (int pw = 0; pw < P * MSM_WINDOWS; pw++) {
    const int32_t *m = meta + (size_t)pw * ACC_META_INTS;
    for (int s = 0; s < slots; s++)
      msm_acc_piece(bx, by, idx, m, m + ACC_META, buckets, extra, pw, s, n, XS);
  }
  for (int h = 1; h < XS; h *= 2)
    for (int pw = 0; pw < P * MSM_WINDOWS; pw++) {
      const int32_t *m = meta + (size_t)pw * ACC_META_INTS;
      if (m[3 * ACC_META] <= h) continue;  // as the kernel's blocks of such a window
      for (int s = 0; s < slots; s++)
        msm_acc_merge(m, m + ACC_META, buckets, extra, pw, s, h, XS);
    }
  delete[] idx;
  delete[] meta;
  delete[] extra;
  delete[] r;
  delete[] sh;
}
// msm_bucket_reduce over P * 32 windows, each as T blocks one after
// another, then its window sum
void msm_reduce_n(const uint32_t *buckets, uint32_t *out, int P, int K, int T) {
  G1Proj *r = new G1Proj[MSM_BUCKETS];
  uint32_t *sF = new uint32_t[MSM_BUCKETS * MSM_PT];
  uint32_t *sT = new uint32_t[MSM_BUCKETS / 2 * MSM_PT];
  uint32_t *part = new uint32_t[(size_t)P * MSM_WINDOWS * T * MSM_PARTS * MSM_PT];
  SerialBlock blk{MSM_BUCKETS, r};
  for (int pw = 0; pw < P * MSM_WINDOWS; pw++) {
    for (int g = 0; g < T; g++) msm_reduce_group(blk, buckets, sF, sT, part, pw, g, T, K);
    msm_window_sum(blk, part, sT, out, pw, T);
  }
  delete[] r;
  delete[] sF;
  delete[] sT;
  delete[] part;
}
}
"""

N_BASE = 16  # distinct multiples of G among the buckets


@pytest.fixture(scope="module")
def msm_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("msmh")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.msm_slices.argtypes = [ctypes.c_int]
    lib.msm_slices.restype = ctypes.c_int
    lib.msm_reduce_n.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
    lib.msm_acc_n.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    return lib


@pytest.fixture(scope="module")
def bases():
    rs = np.random.default_rng(21)
    ks = [int(k) for k in rs.integers(1, 1 << 62, size=N_BASE)]
    return ks, [g1_mul(G1_GEN, k) for k in ks]


def _buckets(P, K, seed, bases):
    """(P, K, 32, 256, 3, 8) int32 buckets and their scalars e (P, K, 32,
    256; 0 for the identity): about a fifth of the buckets and, for K > 1,
    one whole chunk of every (p, w) the identity; bucket 0 a point (to be
    ignored)."""
    ks, pts = bases
    rs = np.random.default_rng(seed)
    idx = rs.integers(0, N_BASE, size=(P, K, 32, 256))
    ident = rs.random((P, K, 32, 256)) < 0.2
    if K > 1:
        ident[:, K // 2, :, 1:] = True  # all-identity chunks
    zs = rs.integers(1, 1 << 62, size=(P, K, 32, 256))
    vals, scal = [], np.zeros((P, K, 32, 256), dtype=object)
    for pos in np.ndindex(P, K, 32, 256):
        z = int(zs[pos])
        if ident[pos] and pos[3] != 0:
            vals += [0, z, 0]  # (0 : z : 0), the identity
        else:
            x, y = pts[idx[pos]]
            vals += [x * z % Q_MOD, y * z % Q_MOD, z]
            scal[pos] = ks[idx[pos]]
    limbs = tf.fq.to_mont_limbs(vals, "cpu").reshape(P, K, 32, 256, 3, 8)
    return limbs.contiguous(), scal


def _affine(wsums):
    """(P, 32, 3, 8) projective Montgomery window sums -> affine points."""
    ints = tf.fq.from_mont_limbs(wsums.reshape(-1, 8))
    out = []
    for X, Y, Z in zip(ints[0::3], ints[1::3], ints[2::3]):
        if Z == 0:
            out.append(None)
        else:
            zi = pow(Z, Q_MOD - 2, Q_MOD)
            out.append((X * zi % Q_MOD, Y * zi % Q_MOD))
    return out


def test_reduce_slices(msm_lib):
    """The slicing of the prover's batches at n = 16384 ((P, K) = (8, 64),
    (1, 512), (5, 128), (2, 256)): P * 32 * T blocks, 256 or 320 each, of
    64 chunks a slice; and of small or odd K."""
    want = {64: 1, 512: 8, 128: 2, 256: 4, 640: 8, 4096: 8, 1: 1, 3: 1, 65: 2, 129: 4}
    assert {K: msm_lib.msm_slices(K) for K in want} == want


@pytest.mark.parametrize("P,K", [(1, 1), (2, 3), (1, 4)], ids=["P1K1", "P2K3", "P1K4"])
def test_reduce_blocks_match_plain(msm_lib, bases, P, K):
    buckets, scal = _buckets(P, K, 100 + K, bases)
    plain = _affine(tm.msm_bucket_reduce_plain(buckets))
    b = np.arange(256)
    want = []
    for p in range(P):
        for w in range(32):
            e = sum(int(v) for v in (scal[p, :, w, 1:].sum(axis=0) * b[1:])) % R_MOD
            want.append(g1_mul(G1_GEN, e) if e else None)
    assert plain == want and want.count(None) < len(want) // 4
    src = np.ascontiguousarray(buckets.numpy())
    for T in (1, 2, 4, 8):
        out = np.zeros((P, 32, 3, 8), np.int32)
        msm_lib.msm_reduce_n(src.ctypes.data, out.ctypes.data, P, K, T)
        assert _affine(torch.from_numpy(out)) == want, f"T = {T}"


# ---------------------------------------------------------------- accumulate

ACC_N, ACC_P = 1024, 3


def _acc_rows(kind: str):
    """ACC_P rows of ACC_N scalars of one kind (see the module docstring)."""
    rs = np.random.default_rng({"dense": 41, "zero_row": 42, "ones": 43, "small": 44,
                                "repeated": 45}[kind])

    def dense():
        return [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(ACC_N)]

    if kind == "dense":
        return [dense() for _ in range(ACC_P)]
    if kind == "zero_row":
        return [dense(), [0] * ACC_N, dense()]
    if kind == "ones":
        return [[1] * ACC_N, dense(), [1] * ACC_N]
    if kind == "small":
        return [[int(v) for v in rs.integers(0, 1 << 16, size=ACC_N)] for _ in range(ACC_P)]
    return [[int.from_bytes(rs.bytes(32), "little") % R_MOD] * ACC_N for _ in range(ACC_P)]


ACC_KINDS = ("dense", "zero_row", "ones", "small", "repeated")


def _acc_points():
    rs = np.random.default_rng(40)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=64)]
    return [pts[i % 64] for i in range(ACC_N)]


@pytest.fixture(scope="module", autouse=True)
def acc_jax():
    """The JAX package's msm over every kind's rows (one call, P = 15), as
    host affine points, started in a thread when the module's first test
    starts (it takes minutes on the CPU: the XLA bucket scan over all rows)
    while the other tests run."""

    def run():
        from uzkge_tpu.ff.jax_field import fr_ctx
        from uzkge_tpu.msm import msm as jm

        flat = [v for kind in ACC_KINDS for r in _acc_rows(kind) for v in r]
        jsc = fr_ctx.to_mont_limbs(flat).reshape(len(ACC_KINDS) * ACC_P, ACC_N, 16)
        return jm.msm(jm.MSMBases(_acc_points()), jsc)

    with ThreadPoolExecutor(1) as ex:
        yield ex.submit(run)


@pytest.mark.parametrize("kind", ACC_KINDS)
def test_accumulate_matches_jax_and_host(msm_lib, acc_jax, kind):
    """msm.cuh's sort, pieces and merge (g++) equal msm_bucket_accumulate_plain
    limb for limb at L = pick_piece (2) and L = 7; their window sums,
    through the reduce, are the host Pippenger's points and the JAX
    package's msm."""
    points, rows = _acc_points(), _acc_rows(kind)
    want = [tm.host_msm(points, r) for r in rows]
    bases = tm.MSMBases(points, "cpu")
    sc = tf.fr.to_mont_limbs([v for r in rows for v in r], "cpu").reshape(ACC_P, ACC_N, 8)
    std = tf.fr.from_mont(sc)
    L0 = tm.pick_piece(ACC_N, ACC_P, "cpu")
    assert L0 == 2
    for L in (L0, 7):
        plain = tm.msm_bucket_accumulate(bases.x, bases.y, std, L)
        assert plain.shape == (ACC_P, 1, 32, 256, 3, 8)
        got = np.zeros(plain.shape, np.int32)
        msm_lib.msm_acc_n(bases.x.data_ptr(), bases.y.data_ptr(), std.data_ptr(),
                          got.ctypes.data, ACC_P, ACC_N, L)
        assert torch.equal(torch.from_numpy(got), plain), f"L = {L}"
        assert tm._window_sums_to_points(tm.msm_bucket_reduce(plain)) == want, f"L = {L}"
    assert (want[1] is None) == (kind == "zero_row")
    at = ACC_KINDS.index(kind) * ACC_P
    assert acc_jax.result()[at:at + ACC_P] == want
