"""The port's proof batch (uzkge_tpu_torch/parallel/batch.py) against the JAX
package's `prove_shuffle_batch`, and the kernel library's first build under
threads, on the CPU.

A shuffle proof takes minutes on this CPU, so both packages' `prove_shuffle`
is replaced by the same cheap stand-in, which records the device and the
thread each proof ran on and returns a value drawn from its rng: the batch's
dispatch (which device and thread take proof i, the order of the results,
the inline path for one device or one deck) is then compared.  The port's
devices are "cpu" (where the KZG is) and "meta" (a second device kind that
makes a replica without data); the JAX package's are its first CPU devices.
The slow test holds a real batch of two small proofs on two CPU threads
against the same proofs made one after another.
"""

import random
import threading
import time
from dataclasses import dataclass

import pytest
import torch

from uzkge_tpu_torch import kernels
from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, G2_GEN
from uzkge_tpu_torch.parallel import batch
from uzkge_tpu_torch.pcs.kzg import KZG


@dataclass
class _PP:
    """A stand-in proving key: one tensor and one host field."""

    coefs: torch.Tensor
    n: int = 4


def _stand_in(log, device_of):
    def prove_shuffle(rng, apk, deck, pp, kzg):
        log.append((deck, device_of(pp, kzg), threading.get_ident()))
        time.sleep(0.05)  # long enough for the pool to start every worker
        return rng.randrange(R_MOD), [c * 2 for c in deck]

    return prove_shuffle


def _run_port(monkeypatch, ndev, ndecks):
    from uzkge_tpu_torch.shuffle import app

    log = []
    monkeypatch.setattr(app, "prove_shuffle",
                        _stand_in(log, lambda pp, kzg: (kzg.device.type, pp.coefs.device.type)))
    devs = ["cpu", "meta", "meta"][:ndev]
    kzg = KZG([G1_GEN] * 4, [G2_GEN, G2_GEN], device="cpu")
    pp = _PP(torch.arange(32, dtype=torch.int32).reshape(4, 8))
    rngs = [random.Random(100 + i) for i in range(ndecks)]
    out = batch.prove_shuffle_batch(rngs, None, [[i, i + 1] for i in range(ndecks)], pp, kzg,
                                    devices=devs)
    return out, log, [(torch.device(devs[i % ndev]).type,) * 2 for i in range(ndecks)]


def _run_jax(monkeypatch, ndev, ndecks):
    import jax
    import jax.numpy as jnp

    from uzkge_tpu.parallel import batch as jbatch
    from uzkge_tpu.shuffle import app as japp

    log = []
    monkeypatch.setattr(japp, "prove_shuffle",
                        _stand_in(log, lambda pp, kzg: str(jax.config.jax_default_device)))
    devs = jax.devices()[:ndev]
    pp = _JaxPP(jnp.arange(32, dtype=jnp.uint32))
    rngs = [random.Random(100 + i) for i in range(ndecks)]
    out = jbatch.prove_shuffle_batch(rngs, None, [[i, i + 1] for i in range(ndecks)], pp, None,
                                     devices=devs)
    return out, log, [str(devs[i % ndev]) for i in range(ndecks)]


@dataclass
class _JaxPP:
    coefs: object


@pytest.mark.parametrize("ndev,ndecks", [(2, 5), (3, 4), (1, 3), (2, 1)])
def test_batch_dispatch_matches_jax(monkeypatch, ndev, ndecks):
    main = threading.get_ident()
    runs = [_run_port(monkeypatch, ndev, ndecks), _run_jax(monkeypatch, ndev, ndecks)]
    assert runs[0][0] == runs[1][0]  # the results, in input order
    assert [o[1] for o in runs[0][0]] == [[i * 2, i * 2 + 2] for i in range(ndecks)]
    for out, log, want_dev in runs:
        by_deck = {deck[0]: (dev, tid) for deck, dev, tid in log}
        assert sorted(by_deck) == list(range(ndecks))
        assert [by_deck[i][0] for i in range(ndecks)] == want_dev
        threads = {tid for _, tid in by_deck.values()}
        if ndev == 1 or ndecks == 1:  # inline, in order, in the caller's thread
            assert threads == {main} and [d[0] for d, _, _ in log] == list(range(ndecks))
        else:  # one worker thread per listed device
            assert main not in threads and len(threads) == min(ndev, ndecks)


def test_replica_cache():
    import jax
    import jax.numpy as jnp

    from uzkge_tpu.parallel import batch as jbatch

    kzg = KZG([G1_GEN] * 4, [G2_GEN, G2_GEN], device="cpu", fixed_base=False)
    kzg.set_lagrange([G1_GEN] * 4)
    pp = _PP(torch.arange(32, dtype=torch.int32).reshape(4, 8))
    assert batch._pp_for_device(pp, kzg, "cpu") == (pp, kzg)  # kzg's own device: itself
    assert not hasattr(pp, "_device_replicas")
    rep = batch._pp_for_device(pp, kzg, "meta")
    assert batch._pp_for_device(pp, kzg, "meta") is rep  # made once
    pp_m, kzg_m = rep
    assert pp_m.coefs.device.type == "meta" and pp_m.n == 4 and kzg_m.device.type == "meta"
    assert kzg_m.fixed_base is False and kzg_m.lagrange_n == 4 and kzg_m.g1_powers is kzg.g1_powers
    assert kzg_m._lagrange_fb is None and kzg_m._lagrange_vb is None  # built on first commit
    # replicate itself always copies, also onto the device pp is on
    pp_c, kzg_c = batch.replicate(pp, kzg, "cpu")
    assert pp_c.coefs.data_ptr() != pp.coefs.data_ptr() and torch.equal(pp_c.coefs, pp.coefs)
    assert kzg_c is not kzg and kzg_c.device == kzg.device
    assert batch._pp_for_device(pp, kzg, "cpu") == (pp, kzg)
    # the JAX package caches its replicas the same way
    jpp = _JaxPP(jnp.arange(4))
    dev = jax.devices()[1]
    assert jbatch._pp_for_device(jpp, dev) is jbatch._pp_for_device(jpp, dev)


def test_group_kzg_refused():
    kzg = KZG([G1_GEN] * 4, [G2_GEN, G2_GEN], device="cpu", group=object())
    pp = _PP(torch.zeros(4, 8, dtype=torch.int32))
    with pytest.raises(ValueError, match="process group"):
        batch.replicate(pp, kzg, "cpu")
    with pytest.raises(ValueError, match="process group"):
        batch.prove_shuffle_batch([None] * 2, None, [[1], [2]], pp, kzg, devices=["cpu", "cpu"])


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        batch.prove_shuffle_batch([random.Random(1)], None, [[1]], None, None)


def _together(fn, n=3):
    """fn() on n threads started at once; returns their results."""
    out = []
    threads = [threading.Thread(target=lambda: out.append(fn())) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_kernel_library_builds_once_under_threads(monkeypatch):
    """Two threads call library() at once: one builds and loads, the other
    waits for it."""
    built, loaded = [], []

    def build():
        built.append(threading.get_ident())
        time.sleep(0.2)
        return "libstub.so"

    class _Fn:
        pass

    class _Lib:
        def __getattr__(self, name):
            return _Fn()

    def cdll(path):
        loaded.append(path)
        return _Lib()

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", cdll)
    libs = _together(kernels.library, 2)
    assert len(built) == 1 and loaded == ["libstub.so"]
    assert len(libs) == 2 and libs[0] is libs[1]


def test_lazy_members_built_once_under_threads(monkeypatch):
    """The KZG's table and MSM bases and the domain cache are made once when
    the batch's threads ask for them at once."""
    from uzkge_tpu_torch.ntt import ntt
    from uzkge_tpu_torch.pcs import kzg as kzg_mod

    made = []

    def slow(kind):
        def make(*args, **kw):
            made.append(kind)
            time.sleep(0.1)
            return object()
        return make

    monkeypatch.setattr(kzg_mod, "FixedBaseTable", slow("table"))
    monkeypatch.setattr(kzg_mod, "MSMBases", slow("bases"))
    monkeypatch.setattr(ntt, "NTTDomain", slow("domain"))
    kzg = KZG([G1_GEN] * 4, [G2_GEN, G2_GEN], device="cpu")
    kzg.set_lagrange([G1_GEN] * 4)
    for fn in (kzg.lagrange_fb_table, kzg._lagrange_msm_bases, kzg._coef_msm_bases,
               lambda: ntt.get_domain(1 << 20, "cpu")):
        got = _together(fn)
        assert len(got) == 3 and got[0] is got[1] is got[2]
    assert sorted(made) == ["bases", "bases", "domain", "table"]
    del ntt._DOMAINS[(1 << 20, "cpu")]  # the stand-in domain


def test_kernel_objects_named_per_thread(monkeypatch, tmp_path):
    """Two threads building at once write their object files and library
    under different names."""
    outs = []

    class _Proc:
        returncode = 0

        def communicate(self):
            time.sleep(0.1)
            return "", ""

    def popen(cmd, **kw):
        outs.append(cmd[cmd.index("-o") + 1])
        return _Proc()

    class _Done:
        returncode = 0
        stderr = ""

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        outs.append(out)
        open(out, "wb").close()
        return _Done()

    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kernels.subprocess, "Popen", popen)
    monkeypatch.setattr(kernels.subprocess, "run", run)
    _together(kernels.build, 2)
    assert len(outs) == 2 * (len(kernels.SOURCES) + 1)
    assert len(set(outs)) == len(outs)
    assert (tmp_path / "libuzkge_kernels.so").exists()


@pytest.mark.slow
def test_threaded_batch_equals_serial_proofs():
    """Two 2-card proofs on two CPU threads equal, byte for byte, the same
    proofs made one after another (a few minutes)."""
    from uzkge_tpu_torch.plonk.indexer import refresh_prover_params_public_key
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.shuffle import app

    torch.set_num_threads(2)
    pp, cs, kzg = app.gen_shuffle_prover_params(2, "cpu")
    joint, deck = app.seeded_game(random.Random(3), 2)
    refresh_prover_params_public_key(pp, cs, kzg, joint)
    decks = [deck, list(reversed(deck))]
    got = batch.prove_shuffle_batch([random.Random(10), random.Random(11)], joint, decks, pp,
                                    kzg, devices=["cpu", "cpu"])
    for i, (proof, outputs) in enumerate(got):
        want, want_out = app.prove_shuffle(random.Random(10 + i), joint, decks[i], pp, kzg)
        assert proof_to_bytes_be(proof) == proof_to_bytes_be(want)
        assert [c.flatten() for c in outputs] == [c.flatten() for c in want_out]
        assert app.verify_shuffle(pp.verifier_params, kzg, decks[i], outputs, proof)
