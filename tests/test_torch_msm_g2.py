"""The port's G2 Pippenger (uzkge_tpu_torch/msm/msm_g2.py, csrc/g2.cuh,
csrc/msm_g2.cuh) against the host arithmetic, exactly.

  * csrc/g2.cuh, compiled with g++: the Fq2 product and square against
    the JAX package's curve/bn254.py fq2_mul (zero, one, q - 1 and seeded
    values), and the complete additions g2_madd, g2_padd and g2_dbl, scaled
    projectively by seeded z, against its g2_add as affine points: the
    identity on either side, P = Q, P = -Q and seeded multiples of the
    generator;
  * groth16/ark_prove.py::device_g2_msm on the CPU (the kernels' plain
    versions, msm_g2's wrappers, the host's window combine) against the JAX
    package's host Pippenger g2_msm_host, on 300 query points and the
    prover's two extra terms (beta_g2 at scalar 1, delta_g2 at s): identity
    entries in the query, zero scalars, scalars 1 and r - 1, one point twice
    (so some bucket holds it twice), below-2^16 scalars; the plain halves'
    outputs of that call against csrc/msm_g2.cuh's sort, pieces, merge levels
    and window sums (g++, threads in turn) limb for limb;
  * the wrappers' argument checks;
  * on a card (marker on_cuda): both kernels against their plain versions at
    the reveal's G2 shape (4871 bases with the two extra terms, the reveal's
    kind of scalars), limb for limb, and a seeded on-chain reveal on the card
    whose proof equals the JAX host route's bytes (the golden digest),
    verifies, and launches each G2 kernel once and msm_bucket_reduce four
    times.
Inputs come from seeded generators.  Only the CPU tests import the JAX
package's oracles (uzkge_tpu.curve.bn254, uzkge_tpu.groth16.ark_prove),
inside the tests, so the on_cuda tests run with `pytest --noconftest -m
on_cuda` where there is no JAX.
"""

import ctypes
import os
import random
import shutil
import subprocess

import pytest
import torch

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.constants.bn254 import Q_MOD, R_MOD
from uzkge_tpu_torch.curve.bn254 import G2_GEN, fq2_mul, g2_add, g2_neg
from uzkge_tpu_torch.ff.field import fq, ints_to_limbs
from uzkge_tpu_torch.groth16 import ark_prove as pa
from uzkge_tpu_torch.msm import msm_g2 as mg

torch.set_num_threads(1)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "uzkge_tpu_torch", "csrc")

_HARNESS = r"""
#include <string.h>
#include "msm_g2.cuh"
// a block on the host: its threads run in turn between barriers
template <class Pt> struct SerialBlock {
  int B;
  Pt *r;
  template <class F> void each(F f) { for (int t = 0; t < B; t++) f(t, r[t]); }
  void sync() {}
};
extern "C" {
// r[i] = a[i] b[i] (sqr = 0) or a[i]^2 (sqr = 1), Fq2 elements of 16 words
void fq2_n(const uint32_t *a, const uint32_t *b, uint32_t *r, int N, int sqr) {
  for (int i = 0; i < N; i++) {
    Fq2 x, y, z;
    memcpy(&x, a + 16 * i, 64);
    memcpy(&y, b + 16 * i, 64);
    if (sqr) fq2_sqr(z, x);
    else fq2_mul(z, x, y);
    memcpy(r + 16 * i, &z, 64);
  }
}
// op 0: r = p + (affine q), 1: r = p + q, 2: r = 2p; points of 48 words (X,
// Y, Z, each c0 then c1), the affine q of 32
void g2_n(const uint32_t *p, const uint32_t *q, uint32_t *r, int N, int op) {
  for (int i = 0; i < N; i++) {
    G2Proj a, b, c;
    memcpy(&a, p + 48 * i, 192);
    memcpy(&b, q + 48 * i, 192);
    if (op == 0) g2_madd(c, a, b.x, b.y);
    else if (op == 1) g2_padd(c, a, b);
    else g2_dbl(c, a);
    memcpy(r + 48 * i, &c, 192);
  }
}
// g2_bucket_accumulate: each window's sort block, then every piece slot of
// every window, then each merge level; buckets' c1 plane zero on entry
void g2_acc(const uint32_t *bases, const uint8_t *std_bytes, uint32_t *buckets, int n, int L) {
  const int XS = (n + L - 1) / L, slots = XS + MSM_BUCKETS - 1;
  int32_t *idx = new int32_t[(size_t)MSM_WINDOWS * n];
  int32_t *meta = new int32_t[(size_t)MSM_WINDOWS * ACC_META_INTS];
  uint32_t *extra = new uint32_t[(size_t)2 * MSM_WINDOWS * XS * MSM_PT];
  G1Proj *r = new G1Proj[ACC_SORT_THREADS];
  int *sh = new int[ACC_SORT_SHARED];
  SerialBlock<G1Proj> blk{ACC_SORT_THREADS, r};
  for (int w = 0; w < MSM_WINDOWS; w++)
    msm_acc_sort(blk, std_bytes, idx, meta, buckets, sh, w, n, L);
  for (int w = 0; w < MSM_WINDOWS; w++) {
    const int32_t *m = meta + (size_t)w * ACC_META_INTS;
    for (int s = 0; s < slots; s++)
      g2_acc_piece(bases, idx, m, m + ACC_META, buckets, extra, w, s, n, XS);
  }
  for (int h = 1; h < XS; h *= 2)
    for (int w = 0; w < MSM_WINDOWS; w++) {
      const int32_t *m = meta + (size_t)w * ACC_META_INTS;
      if (m[3 * ACC_META] <= h) continue;  // as the kernel's blocks of such a window
      for (int s = 0; s < slots; s++) g2_acc_merge(m, m + ACC_META, buckets, extra, w, s, h, XS);
    }
  delete[] idx;
  delete[] meta;
  delete[] extra;
  delete[] r;
  delete[] sh;
}
// g2_bucket_reduce: each window's block
void g2_reduce(const uint32_t *buckets, uint32_t *out) {
  G2Proj *r = new G2Proj[G2_REDUCE_THREADS], *slot = new G2Proj[G2_REDUCE_THREADS];
  SerialBlock<G2Proj> blk{G2_REDUCE_THREADS, r};
  for (int w = 0; w < MSM_WINDOWS; w++) g2_window_sum(blk, buckets, slot, out, w);
  delete[] r;
  delete[] slot;
}
}
"""


@pytest.fixture(scope="module")
def g2_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("g2h")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC,
                    "-o", str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.fq2_n.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.g2_n.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.g2_acc.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.g2_reduce.argtypes = [ctypes.c_void_p] * 2
    return lib


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _mont(values):
    """python ints -> (N, 8) Fq Montgomery limbs."""
    return fq.to_mont_limbs(list(values), "cpu")


def _multiples(n):
    out = [G2_GEN]
    for _ in range(n - 1):
        out.append(g2_add(out[-1], G2_GEN))
    return out


def _proj(p, z):
    """Affine p (None: the identity) as projective Fq2 ints, scaled by z."""
    if p is None:
        return [0, 0, z[0], z[1], 0, 0]
    (x, y) = p
    return [*fq2_mul(x, z), *fq2_mul(y, z), *z]


def _affine(words):
    """(N, 48) Montgomery words -> affine points (None for Z = 0), by the
    JAX package's Fq2 inverse and product."""
    from uzkge_tpu.curve.bn254 import fq2_inv, fq2_mul

    v = fq.from_mont_limbs(words.reshape(-1, 8))
    out = []
    for i in range(0, len(v), 6):
        X, Y, Z = (v[i], v[i + 1]), (v[i + 2], v[i + 3]), (v[i + 4], v[i + 5])
        if Z == (0, 0):
            out.append(None)
        else:
            zi = fq2_inv(Z)
            out.append((fq2_mul(X, zi), fq2_mul(Y, zi)))
    return out


def test_fq2_product_and_square(g2_lib):
    from uzkge_tpu.curve.bn254 import fq2_mul

    rng = random.Random(3)
    edge = [0, 1, Q_MOD - 1]
    a = [(x, y) for x in edge for y in edge] + [(rng.randrange(Q_MOD), rng.randrange(Q_MOD))
                                               for _ in range(200)]
    b = a[::-1]
    A, B = (_mont(v for e in s for v in e).reshape(len(s), 16) for s in (a, b))
    for sqr, want in ((0, [fq2_mul(x, y) for x, y in zip(a, b)]),
                      (1, [fq2_mul(x, x) for x in a])):
        out = torch.empty_like(A)
        g2_lib.fq2_n(_ptr(A), _ptr(B), _ptr(out), len(a), sqr)
        got = fq.from_mont_limbs(out.reshape(-1, 8))
        assert list(zip(got[0::2], got[1::2])) == want


def _point_cases():
    """(P, Q) affine pairs, None the identity: the identity on either side
    and both, P = Q, P = -Q, and seeded pairs of distinct multiples."""
    rng = random.Random(5)
    m = _multiples(40)
    cases = [(None, m[3]), (m[3], None), (None, None), (m[7], m[7]), (m[7], g2_neg(m[7])),
             (m[0], m[1]), (m[1], m[0])]
    cases += [(m[rng.randrange(40)], m[rng.randrange(40)]) for _ in range(24)]
    return cases


@pytest.mark.parametrize("op", ["madd", "padd", "dbl"])
def test_g2_additions(g2_lib, op):
    """g2_madd (the affine operand never the identity), g2_padd and g2_dbl
    on seeded projective scalings, as affine points, against the JAX
    package's g2_add."""
    from uzkge_tpu.curve.bn254 import g2_add

    rng = random.Random({"madd": 7, "padd": 8, "dbl": 9}[op])
    cases = _point_cases()
    if op == "madd":
        cases = [(p, q) for p, q in cases if q is not None]
    z = lambda: (rng.randrange(1, Q_MOD), rng.randrange(Q_MOD))  # noqa: E731
    P = _mont(v for p, _ in cases for v in _proj(p, z())).reshape(len(cases), 48)
    Q = _mont(v for _, q in cases for v in _proj(q, (1, 0) if op == "madd" else z()))
    out = torch.empty_like(P)
    g2_lib.g2_n(_ptr(P), _ptr(Q.reshape(len(cases), 48)), _ptr(out), len(cases),
                ["madd", "padd", "dbl"].index(op))
    want = [g2_add(p, p) if op == "dbl" else g2_add(p, q) for p, q in cases]
    assert _affine(out) == want


@pytest.fixture(scope="module")
def g2_run():
    """device_g2_msm on the CPU over a 300-point query with identities and a
    repeated point, and the prover's two extra terms; the inputs and outputs
    of its plain accumulate and reduce, kept as it calls them."""
    rng = random.Random(17)
    query = _multiples(300)
    for i in range(4, 300, 37):
        query[i] = None
    query[250] = query[11]  # one point twice
    z = [rng.randrange(R_MOD) for _ in range(300)]
    z[:6] = [0, 1, R_MOD - 1, 0, 1, 1]
    z[20:40] = [rng.randrange(1 << 16) for _ in range(20)]
    z[250] = z[11]  # the same point and scalar: one bucket of each window holds it twice
    s = rng.randrange(R_MOD)
    beta, delta = query[5], query[9]  # two extra terms on points of the query
    points, scalars = query + [beta, delta], z + [1, s]
    seen = {}
    acc, red = mg.g2_bucket_accumulate, mg.g2_bucket_reduce

    def spy_acc(bases, std, L):
        seen["acc"] = (bases, std, L, acc(bases, std, L))
        return seen["acc"][-1]

    def spy_red(buckets):
        seen["red"] = red(buckets)
        return seen["red"]

    mg.g2_bucket_accumulate, mg.g2_bucket_reduce = spy_acc, spy_red
    try:
        got = pa.device_g2_msm({}, "b2", points, scalars, "cpu")
    finally:
        mg.g2_bucket_accumulate, mg.g2_bucket_reduce = acc, red
    return points, scalars, got, seen


def test_device_g2_msm_matches_host(g2_run):
    from uzkge_tpu.groth16.ark_prove import g2_msm_host

    points, scalars, got, seen = g2_run
    assert got is not None and got == g2_msm_host(points, scalars)
    bases, std, L, _ = seen["acc"]
    assert L == mg.G2_PIECE and bases.shape[0] == sum(p is not None for p in points)
    assert fq.from_mont_limbs(bases[0]) == [*points[0][0], *points[0][1]]


def test_header_matches_plain(g2_lib, g2_run):
    """msm_g2.cuh's sort, pieces and merge levels (g++) give the plain
    accumulate's buckets, and its window sums the plain reduce's, limb for
    limb."""
    bases, std, L, buckets = g2_run[3]["acc"]
    out = torch.zeros_like(buckets)
    g2_lib.g2_acc(_ptr(bases), _ptr(std), _ptr(out), std.shape[0], L)
    assert torch.equal(out, buckets)
    sums = torch.empty_like(g2_run[3]["red"])
    g2_lib.g2_reduce(_ptr(buckets), _ptr(sums))
    assert torch.equal(sums, g2_run[3]["red"])


def test_g2_wrappers_check_arguments():
    b = torch.zeros(8, 4, 8, dtype=torch.int32)
    std = torch.zeros(8, 8, dtype=torch.int32)
    with pytest.raises(ValueError):
        mg.g2_bucket_accumulate(b, std, 0)  # L < 1
    with pytest.raises(ValueError):
        mg.g2_bucket_accumulate(b[:4], std, 2)
    with pytest.raises(TypeError):
        mg.g2_bucket_accumulate(b.long(), std, 2)
    with pytest.raises(ValueError):
        mg.g2_bucket_reduce(torch.zeros(2, 32 * 256, 2, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        mg.g2_bucket_reduce(torch.zeros(2, 32 * 256, 3, 8, dtype=torch.int32, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


@pytest.mark.on_cuda
def test_g2_kernels_match_plain_at_reveal_shape(cuda_device):
    """The reveal's G2 MSM shape: 4869 query points and the two extra terms;
    scalars as a reveal's assignment has them (mostly 0 and 1, the rest
    dense): the accumulate's buckets and the reduce's window sums limb for
    limb, once each."""
    rng = random.Random(29)
    n = 4871
    base = _multiples(97)
    points = [g2_add(base[i % 97], base[(i // 97) % 97]) for i in range(n)]
    scalars = [rng.choice((0, 1, 1, rng.randrange(R_MOD))) for _ in range(n)]
    bases = mg.g2_bases(points).to(cuda_device)
    std = torch.from_numpy(ints_to_limbs(scalars)).to(cuda_device)
    before = dict(kernels.LAUNCHES)
    kb = mg.g2_bucket_accumulate(bases, std, mg.G2_PIECE)
    ks = mg.g2_bucket_reduce(kb)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["g2_bucket_accumulate"] == before["g2_bucket_accumulate"] + 1
    assert kernels.LAUNCHES["g2_bucket_reduce"] == before["g2_bucket_reduce"] + 1
    assert torch.equal(kb, mg.g2_bucket_accumulate_plain(bases, std, mg.G2_PIECE))
    assert torch.equal(ks, mg.g2_bucket_reduce_plain(kb))


@pytest.mark.on_cuda
def test_reveal_on_the_card_matches_host_route(cuda_device):
    """The seeded on-chain reveal on the card: its words' sha256 equal the
    golden one (the JAX package's host route for the same r and s: an affine
    result is unique), the proof verifies, and one reveal launches each G2
    kernel once and msm_bucket_reduce four times."""
    import json

    from uzkge_tpu_torch.curve import babyjubjub as bjj
    from uzkge_tpu_torch.groth16 import reveal

    from .torch_golden import reveal_digest

    golden = json.load(open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                                         "torch_golden.json")))["reveal"]
    reveal_digest(reveal, golden["seed"], device=cuda_device)  # loads the key, builds the bases
    before = dict(kernels.LAUNCHES)
    digest, (sk, e1, reveal_pt, proof) = reveal_digest(reveal, golden["seed"], device=cuda_device)
    torch.cuda.synchronize()
    assert digest == golden["sha256"]
    assert reveal.verify_reveal_onchain(e1, reveal_pt, bjj.mul(bjj.GENERATOR, sk), proof)
    counts = {k: kernels.LAUNCHES[k] - before[k]
              for k in ("g2_bucket_accumulate", "g2_bucket_reduce", "msm_bucket_reduce")}
    assert counts == {"g2_bucket_accumulate": 1, "g2_bucket_reduce": 1, "msm_bucket_reduce": 4}
