"""ntt_pass's block schedule (uzkge_tpu_torch/csrc/ntt.cuh), compiled by g++,
against the JAX package's Pallas `_direct_kernel`, exactly.

The card runs ntt.cuh's ntt_tile with one CUDA thread per schedule thread;
here a small ctypes harness runs the same template with the threads in turn
(each phase of every thread before the barrier, as on the card), so the CPU
suite checks the kernel's own index arithmetic, shared-memory layout and
mixed-radix steps:
  * against `_direct_kernel`'s body run through the grid interpreter of
    tests/test_pallas_kernels.py (as test_ntt_pass_matches_pallas_direct_kernel
    runs it, with jnp.roll for the TPU's row roll), at S in {2, 8, 64}, IN in {1, 3, 8}, with no ladder and with
    the pre ladder, the post ladder and the constant, forward and inverse;
  * at S = 1024, IN = 2 (5 steps of radix 4, or 10 of radix 2) against
    ntt_pass_plain.
Each pass runs in every geometry the kernel can take (R elements a thread,
G columns a block), the launcher's own pick among them, and all must agree.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.ntt import cuda_ntt
from uzkge_tpu_torch.ntt.ntt import NTTDomain
from uzkge_tpu_torch.ntt.stockham import stage_twiddles_strided

from .test_pallas_kernels import interpret_pallas  # noqa: F401
from .test_torch_field import CSRC
from .test_torch_ntt import _patch_pallas, _rand_mont

torch.set_num_threads(1)

_HARNESS = r"""
#include "ntt.cuh"
// ntt_tile's block on the host: its threads run in turn, so that every
// thread's reads of a step come before any thread's writes; no barrier needed
template <int R> struct SerialNtt {
  int B;
  uint32_t (*v)[R][8];
  template <class F> void each(F f) { for (int t = 0; t < B; t++) f(t, v[t]); }
  void sync() {}
};
template <int R>
void run(const uint32_t *x, uint32_t *y, const uint32_t *tw, const uint32_t *pre,
         const uint32_t *post, const uint32_t *cst, int out, int S, int IN, int G) {
  SerialNtt<R> blk;
  blk.B = S * G / R;
  blk.v = new uint32_t[blk.B][R][8];
  uint32_t *sm = new uint32_t[NttLayout{S, G}.units() * 4];
  for (long long b = 0; b < (long long)out * (IN / G); b++)
    ntt_tile<R>(blk, x, y, tw, pre, post, cst, S, IN, G, b, sm);
  delete[] blk.v;
  delete[] sm;
}
// one geometry: R elements a thread, G columns a block
extern "C" void ntt_pass_n(const uint32_t *x, uint32_t *y, const uint32_t *tw,
                           const uint32_t *pre, const uint32_t *post, const uint32_t *cst,
                           int out, int S, int IN, int R, int G) {
  if (R == 2) run<2>(x, y, tw, pre, post, cst, out, S, IN, G);
  else run<4>(x, y, tw, pre, post, cst, out, S, IN, G);
}
// the launcher's geometry on a card of `sms` SMs
extern "C" void ntt_geometry_n(long long out, int S, int IN, int sms, int *R, int *G) {
  const NttGeometry g = ntt_geometry(out, S, IN, sms);
  *R = g.R;
  *G = g.G;
}
"""


@pytest.fixture(scope="module")
def ntt_lib(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ on this machine")
    d = tmp_path_factory.mktemp("ntth")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    so = d / "harness.so"
    subprocess.run([cxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-I", CSRC, "-o", str(so),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.ntt_pass_n.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
    lib.ntt_geometry_n.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    return lib


def _geometries(lib, OUT, S, IN):
    """Every geometry the kernel can take at (OUT, S, IN): R elements a
    thread in {2, 4} up to S, G columns a block a power of two dividing
    IN, at most 256 threads a block; the launcher's pick on a card of 132
    SMs first."""
    R, G = ctypes.c_int(), ctypes.c_int()
    out = []
    for sms in (132, 1):
        lib.ntt_geometry_n(OUT, S, IN, sms, ctypes.byref(R), ctypes.byref(G))
        out.append((R.value, G.value))
    for r in (2, 4):
        g = 1
        while r <= S and S // r <= 256 and IN % g == 0 and S * g // r <= 256:
            out.append((r, g))
            g *= 2
    return list(dict.fromkeys(out))


def _header_pass(lib, x, tw, pre=None, post=None, const=None):
    """ntt.cuh's schedule over contiguous (OUT, S, IN, 8) int32 tensors in
    every geometry (_geometries): all must give the same limbs, which are
    returned."""
    OUT, S, IN, _ = x.shape

    def p(t):
        return None if t is None else t.contiguous().data_ptr()

    args = [None if t is None else t.contiguous() for t in (pre, post, const)]
    ys = {}
    for R, G in _geometries(lib, OUT, S, IN):
        y = torch.zeros_like(x)
        lib.ntt_pass_n(p(x), p(y), p(tw), *(p(t) for t in args), OUT, S, IN, R, G)
        ys[R, G] = y
    first = next(iter(ys.values()))
    for rg, y in ys.items():
        assert torch.equal(y, first), f"geometry (R, G) = {rg} disagrees"
    return first


@pytest.mark.parametrize("S,IN", [(S, IN) for S in (2, 8, 64) for IN in (1, 3, 8)])
def test_ntt_header_matches_pallas_direct_kernel(ntt_lib, interpret_pallas, monkeypatch,  # noqa: F811
                                                 S, IN):
    """The schedule against _direct_kernel's body on the same (OUT = 1, S, IN)
    block, forward and inverse: no ladder, then the pre and post ladders
    with the constant (n^-1's place)."""
    import jax.numpy as jnp

    nttmod, pnttmod = _patch_pallas(monkeypatch, 64)
    # the kernel's wide interleave (l * IN >= 128) rolls rows with the TPU's
    # pltpu.roll, which the CPU interpreter lacks: jnp.roll is the same shift
    monkeypatch.setattr(pnttmod.pltpu, "roll", lambda v, shift, axis: jnp.roll(v, shift, axis))
    n, OUT = 128, 1
    jd = nttmod.NTTDomain(n)
    master = tf.from_jax_limbs(np.asarray(jd.master), "cpu")
    cval = 0x1234_5678_9ABC_DEF0 * (S + IN) % R_MOD  # a Montgomery form, as n^-1's
    const = torch.from_numpy(tf.ints_to_limbs([cval]).reshape(8))
    const_limbs = tuple((cval >> (16 * i)) & 0xFFFF for i in range(16))
    for inverse in (False, True):
        plan = pnttmod.build_plan(jd.master, n, S, n // S, inverse=inverse)
        tw = stage_twiddles_strided(master, n, S, n // S, inverse)[0]
        x = _rand_mont(OUT * S * IN, 7 * S + IN + inverse).reshape(OUT, S, IN, 16)
        pre = _rand_mont(S * IN, 3 * S + IN)
        post = _rand_mont(S * IN, 5 * S + IN)
        tx = tf.from_jax_limbs(np.asarray(x), "cpu")
        for lad in (False, True):
            want = pnttmod._direct_pass(jnp.moveaxis(x, -1, 0), plan,
                                        jnp.moveaxis(pre, -1, 0) if lad else None,
                                        jnp.moveaxis(post, -1, 0) if lad else None,
                                        const_limbs if lad else None)
            want = np.moveaxis(np.asarray(want), 0, -1)
            got = _header_pass(
                ntt_lib, tx, tw,
                tf.from_jax_limbs(np.asarray(pre), "cpu").reshape(S, IN, 8) if lad else None,
                tf.from_jax_limbs(np.asarray(post), "cpu").reshape(S, IN, 8) if lad else None,
                const if lad else None)
            assert (tf.to_jax_limbs(got) == want).all(), (inverse, lad)


@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
def test_ntt_header_matches_plain_at_1024(ntt_lib, inverse):
    """S = 1024, IN = 2 against ntt_pass_plain, each ladder absent and
    present."""
    S, IN, OUT = 1024, 2, 1
    dom = NTTDomain(2048, "cpu")
    tw = stage_twiddles_strided(dom.master, 2048, S, 2, inverse)[0]
    rs = np.random.default_rng(11 + inverse)

    def rand(*shape):
        vals = [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(int(np.prod(shape)))]
        return tf.fr.to_mont_limbs(vals, "cpu").reshape(*shape, 8)

    x, pre, post, const = rand(OUT, S, IN), rand(S, IN), rand(S, IN), rand()
    for args in ((None, None, None), (pre, post, const)):
        want = cuda_ntt.ntt_pass_plain(x, tw, *args)
        assert torch.equal(_header_pass(ntt_lib, x, tw, *args), want)
