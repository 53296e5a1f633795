"""The torch port's NTT against the JAX package's, exactly.

  * uzkge_tpu_torch/ntt/ntt.py::NTTDomain against uzkge_tpu/ntt/ntt.py at
    n in {16, 256, 4096}, with the port's pass cap lowered where noted so
    that the four-step recursion runs;
  * the ntt_pass plain version against the Pallas `_direct_kernel` body,
    run eagerly through the grid interpreter of tests/test_pallas_kernels.py;
  * on a card (marker on_cuda), the ntt_pass kernel against its plain version.
JAX is imported inside the tests that use it, so that the on_cuda tests also
run where JAX is absent (`pytest --noconftest -m on_cuda`).
"""


import numpy as np
import pytest
import torch

from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.ntt import cuda_ntt
from uzkge_tpu_torch.ntt.ntt import NTTDomain
from uzkge_tpu_torch.ntt.stockham import stage_twiddles_strided

from .test_pallas_kernels import _mini_pallas_call, interpret_pallas  # noqa: F401

torch.set_num_threads(1)


def _rand_mont(count: int, seed: int):
    from uzkge_tpu.ff.jax_field import fr_ctx

    rs = np.random.default_rng(seed)
    words = rs.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R_MOD for row in words]
    return fr_ctx.to_mont_limbs(vals)  # (count, 16) JAX limbs


def _eq(t, j):
    return bool((tf.to_jax_limbs(t) == np.asarray(j)).all())


def test_stage_twiddles_match_jax():
    from uzkge_tpu.ntt.stockham import stage_twiddles_strided as jax_tws
    from uzkge_tpu.ntt.ntt import NTTDomain as JaxDomain

    n = 64
    jd = JaxDomain(n)
    master = tf.from_jax_limbs(np.asarray(jd.master), "cpu")
    for size, stride, inverse in ((16, 4, False), (16, 4, True), (64, 1, True)):
        got = stage_twiddles_strided(master, n, size, stride, inverse)
        want = jax_tws(jd.master, n, size, stride, inverse)
        assert len(got) == len(want)
        for t, (g, w) in enumerate(zip(got, want)):
            assert (tf.to_jax_limbs(g) == np.asarray(w).T).all()
            assert torch.equal(g, got[0][:: 1 << t][: g.shape[0]])


@pytest.mark.parametrize("n,smax", [(16, 1024), (256, 16), (4096, 64)])
def test_domain_matches_jax(n, smax, monkeypatch):
    from uzkge_tpu.ntt.ntt import NTTDomain as JaxDomain

    monkeypatch.setattr(cuda_ntt, "SMAX", smax)
    jd, td = JaxDomain(n), NTTDomain(n, "cpu")
    if smax < n:
        assert "S2" in td._plan_fwd, "the four-step recursion must run"
    jx = _rand_mont(2 * n, n).reshape(2, n, 16)
    tx = tf.from_jax_limbs(np.asarray(jx), "cpu")
    k = 5
    ev = td.fft_batch(tx)
    assert _eq(ev, jd.fft_batch(jx))
    assert _eq(td.ifft_batch(tx), jd.ifft_batch(jx))
    assert _eq(td.coset_fft_batch(tx[:, : n // 2], k), jd.coset_fft_batch(jx[:, : n // 2], k))
    # the single-row entry points share the batched path; round trips close
    assert torch.equal(td.fft(tx[1]), ev[1])
    assert torch.equal(td.ifft(ev[0]), tx[0])
    assert torch.equal(td.coset_ifft(td.coset_fft(tx[0][:3], k), k)[:3], tx[0][:3])
    assert _eq(td.power_ladder(k), jd.power_ladder(k))
    assert td.elements() == jd.elements()


def _patch_pallas(monkeypatch, smax):
    import jax as _jax
    from uzkge_tpu.ntt import ntt as nttmod
    from uzkge_tpu.ntt import pallas_ntt as pnttmod

    monkeypatch.setattr(nttmod, "PALLAS_MIN_N", 16)
    monkeypatch.setattr(pnttmod, "SMAX", smax)
    monkeypatch.setattr(pnttmod, "pallas_call", _mini_pallas_call)
    monkeypatch.setattr(_jax, "jit", lambda f, **kw: f)
    return nttmod, pnttmod


def test_ntt_pass_matches_pallas_direct_kernel(interpret_pallas, monkeypatch):  # noqa: F811
    """One pass with pre / post ladders: the plain ntt_pass against the
    Pallas _direct_kernel body on the same (OUT, S, IN) block."""
    import jax.numpy as jnp

    nttmod, pnttmod = _patch_pallas(monkeypatch, 8)
    n, S, OUT, IN = 16, 8, 2, 4
    jd = nttmod.NTTDomain(n)
    for inverse in (False, True):
        plan = pnttmod.build_plan(jd.master, n, S, 2, inverse=inverse)
        x = _rand_mont(OUT * S * IN, 21 + inverse).reshape(OUT, S, IN, 16)
        pre = _rand_mont(S * IN, 31)
        post = _rand_mont(S * IN, 41)
        want = pnttmod._direct_pass(jnp.moveaxis(x, -1, 0), plan,
                                    jnp.moveaxis(pre, -1, 0), jnp.moveaxis(post, -1, 0), None)
        want = np.moveaxis(np.asarray(want), 0, -1)

        master = tf.from_jax_limbs(np.asarray(jd.master), "cpu")
        tw = stage_twiddles_strided(master, n, S, 2, inverse)[0]
        got = cuda_ntt.ntt_pass(tf.from_jax_limbs(np.asarray(x), "cpu"), tw,
                                pre=tf.from_jax_limbs(np.asarray(pre), "cpu").reshape(S, IN, 8),
                                post=tf.from_jax_limbs(np.asarray(post), "cpu").reshape(S, IN, 8))
        assert (tf.to_jax_limbs(got) == want).all()


def test_domain_matches_pallas_fft_path(interpret_pallas, monkeypatch):  # noqa: F811
    """NTTDomain(16) on the Pallas path (SMAX 8: one split) against the port
    with its cap at 2 (three levels of recursion)."""
    nttmod, _ = _patch_pallas(monkeypatch, 8)
    monkeypatch.setattr(cuda_ntt, "SMAX", 2)
    n = 16
    jd = nttmod.NTTDomain(n)
    assert jd._pallas and "S2" in jd._pplan_fwd
    td = NTTDomain(n, "cpu")
    assert "S2" in td._plan_fwd["plan2"]
    jx = _rand_mont(n, 51)
    tx = tf.from_jax_limbs(np.asarray(jx), "cpu")
    assert _eq(td.fft(tx), jd.fft(jx))
    assert _eq(td.ifft(tx), jd.ifft(jx))
    assert _eq(td.coset_fft(tx, 7), jd.coset_fft(jx, 7))
    assert _eq(td.coset_ifft(tx, 7), jd.coset_ifft(jx, 7))


def test_ntt_pass_checks_arguments():
    x = torch.zeros(1, 8, 1, 8, dtype=torch.int32)
    tw = torch.zeros(4, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_ntt.ntt_pass(x.to(torch.int64), tw)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass(x, tw[:3])
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass(x, tw, pre=torch.zeros(8, 2, 8, dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_ntt.ntt_pass(x.transpose(1, 2), tw)
    before = dict(kernels.LAUNCHES)
    cuda_ntt.ntt_pass(x, tw)
    assert kernels.LAUNCHES == before, "the CPU path launches no kernel"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


# (OUT, S, IN): the tests' small passes, then the passes of the proof: the
# m = 131072 four-step (S2 = 128 over IN = 1024 with the inter-factor T as
# post ladder, then S1 = 1024 over IN = 128) and the n = 16384 one (16 over
# 1024, 1024 over 16), at the 5-row batch of the quotient's coset ffts
PASS_SHAPES = [(3, 2, 1), (3, 128, 16), (3, 1024, 1), (3, 1024, 8), (1, 1024, 2),
               (5, 128, 1024), (5, 1024, 128), (5, 16, 1024), (5, 1024, 16)]


@pytest.mark.on_cuda
@pytest.mark.parametrize("OUT,S,IN", PASS_SHAPES)
def test_ntt_pass_kernel_matches_plain(cuda_device, OUT, S, IN):
    """The kernel against ntt_pass_plain on the card, on the same canonical
    inputs, with a genuine twiddle table (the schedules differ, so they agree
    only where tw holds the powers of one root of order S), forward and
    inverse, each ladder present and absent."""
    gen = torch.Generator(device=cuda_device).manual_seed(S * 4096 + IN + OUT)

    def rand(shape):  # canonical: values below 2^252 < r
        t = torch.randint(-(1 << 31), 1 << 31, (*shape, 8), dtype=torch.int32,
                          device=cuda_device, generator=gen)
        t[..., 7] &= 0x0FFFFFFF
        return t

    dom = NTTDomain(2048, cuda_device)
    x = rand((OUT, S, IN))
    pre, post, const = rand((S, IN)), rand((S, IN)), rand(())
    for inverse in (False, True):
        tw = stage_twiddles_strided(dom.master, 2048, S, 2048 // S, inverse)[0]
        for args in ((None, None, None), (pre, None, None), (None, post, const),
                     (pre, post, const)):
            want = cuda_ntt.ntt_pass_plain(x, tw, *args)
            before = kernels.LAUNCHES["ntt_pass"]
            got = cuda_ntt.ntt_pass(x, tw, *args)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["ntt_pass"] == before + 1
            assert torch.equal(got, want)
