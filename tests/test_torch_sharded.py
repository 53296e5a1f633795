"""The torch port's sharded proving path against the JAX package's, exactly.

Each group is 2 or 4 gloo ranks in spawned processes (a FileStore under
tmp_path, so that pytest-xdist's workers never share one; a timeout on the
group's collectives and on the join).  The ranks import the port only; the
JAX package's functions run here, on make_mesh(2) and make_mesh(4) of the 8
virtual CPU devices (tests/conftest.py), in threads while the ranks work.
Every rank must return the same, replicated result:
  * sharded_msm_device_sums (the point axis, P = 3) and sharded_msm_batch
    (the proof axis, P = 4) at n = 32, as affine points, against the JAX
    package's sharded_msm on make_mesh(2) and sharded_commit_batch on
    make_mesh(4) (an MSM's points do not depend on the mesh) and the host
    Pippenger, at world sizes 2 and 4;
  * ShardedNTT at n = 64 (fft, ifft, coset_fft, coset_ifft) and
    sharded_ntt_batch at P = 4 (forward, inverse, coset forward) against the
    JAX package's on the mesh of the same size, limb for limb; the coset
    inverse batch against the JAX package's single-device coset_ifft (its
    sharded_ntt_batch raises there: coset_scale pads a batch as one
    polynomial);
  * fold_device_sums against _fold_device_sums at 3 and 5 partial sums (the
    odd-count rule; in this process, no group);
  * dryrun_multichip on every group, and the wrappers' refusals (a batch
    that does not divide among the ranks, an NTT too small for them, a
    tensor on another device than the group's);
  * the n = 64 proof of tests/test_torch_prover.py through a KZG on a group
    of 2 (every Lagrange commit through the sharded chain MSM, the batched
    NTTs through sharded_ntt_batch): its sha256 equals the JAX package's
    proof's, tests/data/torch_golden.json "add64", which
    tests/test_torch_prover.py holds against the JAX package's bytes.
"""

import hashlib
import json
import os
import pickle
import random
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.curve.bn254 import G1_GEN, g1_mul
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.msm.msm import host_msm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_golden.json")
TAU = 987654321987654321
N_PTS, N_NTT, P_NTT = 32, 64, 4
JOIN_S = 400  # the whole run of one group, set-up included
WORLDS = (2, 4)


# ------------------------------------------------------------- the ranks


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _ops(group, ws, inp):
    """The sharded functions on `inp` (see _inputs); host points and tensors."""
    from uzkge_tpu_torch.msm.fixed_base import _extract_host
    from uzkge_tpu_torch.parallel import sharded as sh

    x, y = inp["x"], inp["y"]
    out = {"device_sums": _extract_host(*sh.sharded_msm_device_sums(group, x, y, inp["sc3"])),
           "batch": _extract_host(*sh.sharded_msm_batch(group, x, y, inp["sc4"]))}
    sntt, v, b = sh.ShardedNTT(N_NTT, group), inp["v"], inp["b"]
    out.update(fft=sntt.fft(v), ifft=sntt.ifft(v), coset_fft=sntt.coset_fft(v, 9),
               coset_ifft=sntt.coset_ifft(v, 9),
               batch_fft=sh.sharded_ntt_batch(group, b),
               batch_ifft=sh.sharded_ntt_batch(group, b, inverse=True),
               batch_coset=sh.sharded_ntt_batch(group, b, coset_k=5),
               batch_coset_inv=sh.sharded_ntt_batch(group, b, inverse=True, coset_k=5))
    out["refusals"] = [
        _raises(lambda: sh.sharded_msm_batch(group, x, y, inp["sc3"])),  # 3 rows
        _raises(lambda: sh.ShardedNTT(ws, group)),  # n / ws = 1 row each
        _raises(lambda: sh.sharded_ntt_batch(group, b.to("meta"))),
        _raises(lambda: sh.sharded_msm_device_sums(group, x.to("meta"), y, inp["sc3"])),
    ]
    out["dryrun"] = sh.dryrun_multichip(group)
    return out


def _prove(group, ws, inp):
    """The add-gate proof of tests/test_torch_prover.py, its prover params
    from a Pippenger KZG over the same SRS, proven through a KZG on `group`;
    returns the proof's bytes and what the KZG built for its other routes."""
    import uzkge_tpu_torch.plonk.gadgets  # noqa: F401  (attaches gadget methods)
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.plonk.cs import TurboCS
    from uzkge_tpu_torch.plonk.indexer import indexer
    from uzkge_tpu_torch.plonk.proof_io import proof_to_bytes_be
    from uzkge_tpu_torch.plonk.prover import prover
    from uzkge_tpu_torch.utils.transcript import Transcript

    cs = TurboCS()  # tests/test_torch_prover.py::_add_gate_circuit
    v1, v2, v3 = cs.new_variable(1), cs.new_variable(2), cs.new_variable(3)
    cs.insert_add_gate(v1, v2, v3)
    cs.prepare_pi_variable(v3)
    cs.pad(min_size=64)
    witness = cs.get_and_clear_witness()
    n = cs.size
    base = KZG.setup_insecure(2 * n + 10, tau=TAU, domain_n=n, device="cpu", fixed_base=False)
    pp = indexer(cs, base, with_shuffle=True)
    kzg = KZG(base.g1_powers, base.g2_powers, base._lagrange_points, device="cpu", group=group)
    proof = prover(random.Random(99), Transcript(b"Test"), kzg, cs, pp, witness)
    return {"bytes": proof_to_bytes_be(proof), "routes": (kzg.uses_fixed_base(),
                                                          kzg._lagrange_fb, kzg._lagrange_vb)}


def _rank_main(rank, job, ws, root):
    """One rank: join the gloo group under `root`, run `job` on the inputs
    pickled there, pickle the result (or the traceback) for the test."""
    torch.set_num_threads(1)
    res = {}
    try:
        import torch.distributed as dist

        from uzkge_tpu_torch.parallel import start_group

        group = start_group(root, rank, ws, "gloo", timeout_s=JOIN_S)
        with open(os.path.join(root, "..", "inputs.pkl"), "rb") as f:
            inp = pickle.load(f)
        res = {"ops": _ops, "prove": _prove}[job](group, ws, inp)
        dist.destroy_process_group()
    except Exception:  # reported by the test, which reads this rank's file
        res = {"error": traceback.format_exc()}
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _start(job, ws, base):
    root = os.path.join(base, f"{job}{ws}")
    os.makedirs(root)
    return root, mp.start_processes(_rank_main, args=(job, ws, root), nprocs=ws, join=False,
                                    start_method="spawn")


def _finish(root, ctx, ws):
    """Join the ranks within JOIN_S of now, killing them after it; every
    rank's result, or a string saying what went wrong."""
    deadline = time.time() + JOIN_S
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                return f"{root}: the ranks did not finish within {JOIN_S} s"
    except Exception as e:  # a rank died without writing its result
        return f"{root}: {e}"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = []
    for r in range(ws):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            return f"{root}, rank {r}:\n{res['error']}"
        out.append(res)
    return out


def _ranks(runs, key):
    res = runs[key]
    assert not isinstance(res, str), res
    return res


# -------------------------------------------------------------- the test side


def _inputs():
    rs = np.random.default_rng(404)
    pts = [g1_mul(G1_GEN, int(k)) for k in rs.integers(1, 1 << 62, size=N_PTS)]

    def row():
        return [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(N_PTS)]

    rows3 = [[0] * N_PTS, row(), row()]
    rows3[1][0] = R_MOD - 1
    rows4 = [row() for _ in range(4)]
    rows4[2][:4] = [R_MOD - 1, 0, 1, R_MOD - 1]
    v = [int.from_bytes(rs.bytes(32), "little") % R_MOD for _ in range(N_NTT * (1 + P_NTT))]
    sc = tf.fr.to_mont_limbs
    return {"pts": pts, "rows3": rows3, "rows4": rows4, "v_ints": v,
            "x": tf.fq.to_mont_limbs([p[0] for p in pts], "cpu"),
            "y": tf.fq.to_mont_limbs([p[1] for p in pts], "cpu"),
            "sc3": sc([s for r in rows3 for s in r], "cpu").reshape(3, N_PTS, 8),
            "sc4": sc([s for r in rows4 for s in r], "cpu").reshape(4, N_PTS, 8),
            "v": sc(v[:N_NTT], "cpu"),
            "b": sc(v[N_NTT:], "cpu").reshape(P_NTT, N_NTT, 8)}


def _jax_reference(inp):
    """The JAX package's results on the same inputs, per world size, as port
    tensors and host points, and the host Pippenger's ("host"); each entry is
    computed in its own thread."""
    import jax.numpy as jnp
    from uzkge_tpu.ff.jax_field import L, fr_ctx
    from uzkge_tpu.ntt.ntt import get_domain
    from uzkge_tpu.parallel import sharded as jsh

    for k in (5, 9):  # cache the ladders outside any trace: a first call under
        get_domain(N_NTT).power_ladder(k)  # shard_map's would leave a tracer in the cache
    v = fr_ctx.to_mont_limbs(inp["v_ints"][:N_NTT])
    b = fr_ctx.to_mont_limbs(inp["v_ints"][N_NTT:]).reshape(P_NTT, N_NTT, L)

    def port(a):
        return tf.from_jax_limbs(np.asarray(a), "cpu")

    def ntts(ws):
        mesh = jsh.make_mesh(ws)
        s = jsh.ShardedNTT(N_NTT, mesh)
        dom = get_domain(N_NTT)
        out = {"fft": s.fft(v), "ifft": s.ifft(v), "coset_fft": s.coset_fft(v, 9),
               "coset_ifft": s.coset_ifft(v, 9),
               "batch_fft": jsh.sharded_ntt_batch(mesh, b),
               "batch_ifft": jsh.sharded_ntt_batch(mesh, b, inverse=True),
               "batch_coset": jsh.sharded_ntt_batch(mesh, b, coset_k=5),
               "batch_coset_inv": jnp.stack([dom.coset_ifft(b[i], 5) for i in range(P_NTT)])}
        return {k: port(a) for k, a in out.items()}

    jobs = {"device_sums": lambda: jsh.sharded_msm(jsh.make_mesh(2), inp["pts"], inp["rows3"]),
            "batch": lambda: jsh.sharded_commit_batch(jsh.make_mesh(4), inp["pts"], inp["rows4"]),
            "host": lambda: [[host_msm(inp["pts"], r) for r in inp[k]] for k in ("rows3", "rows4")]}
    jobs.update({f"ntt{ws}": (lambda ws=ws: ntts(ws)) for ws in WORLDS})
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {k: ex.submit(f) for k, f in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{job + ws: every rank's result} for the "ops" job at world sizes 2 and
    4 and the "prove" job at 2, all started at once; "jax": the JAX
    package's results; "inputs"."""
    base = str(tmp_path_factory.mktemp("sharded"))
    inp = _inputs()
    with open(os.path.join(base, "inputs.pkl"), "wb") as f:
        pickle.dump(inp, f)
    started = [("prove", 2)] + [("ops", ws) for ws in WORLDS]
    procs = {f"{job}{ws}": (ws,) + _start(job, ws, base) for job, ws in started}
    try:
        out = {"jax": _jax_reference(inp), "inputs": inp}
    except BaseException:
        for _, _, ctx in procs.values():
            for p in ctx.processes:
                p.kill()
        raise
    for key, (ws, root, ctx) in procs.items():
        out[key] = _finish(root, ctx, ws)
    return out


@pytest.mark.parametrize("ws", WORLDS)
def test_sharded_msm_matches_jax_and_host(runs, ws):
    jax = runs["jax"]
    want3, want4 = jax["host"]
    assert jax["device_sums"] == want3 and jax["batch"] == want4 and want3[0] is None
    for res in _ranks(runs, f"ops{ws}"):
        assert res["device_sums"] == want3 and res["batch"] == want4


NTT_KEYS = ("fft", "ifft", "coset_fft", "coset_ifft", "batch_fft", "batch_ifft", "batch_coset",
            "batch_coset_inv")


@pytest.mark.parametrize("ws", WORLDS)
def test_sharded_ntts_match_jax(runs, ws):
    want = runs["jax"][f"ntt{ws}"]
    for res in _ranks(runs, f"ops{ws}"):
        for key in NTT_KEYS:
            assert torch.equal(res[key], want[key]), key


@pytest.mark.parametrize("ws", WORLDS)
def test_dryrun_and_refusals(runs, ws):
    for res in _ranks(runs, f"ops{ws}"):
        assert res["dryrun"] is True and res["refusals"] == [True] * 4


def test_group_routed_proof_matches_jax_digest(runs):
    """The n = 64 proof through a KZG on a gloo group of 2: both ranks' bytes
    equal, their sha256 the JAX package's, no table or Pippenger built."""
    golden = json.load(open(GOLDEN))["add64"]["sha256"]
    r0, r1 = _ranks(runs, "prove2")
    assert r0["bytes"] == r1["bytes"] and len(r0["bytes"]) > 0
    assert hashlib.sha256(r0["bytes"]).hexdigest() == golden
    assert r0["routes"] == (False, None, None)


@pytest.mark.parametrize("k", [3, 5])
def test_fold_device_sums_matches_jax(k):
    """fold_device_sums against the JAX package's _fold_device_sums at odd
    device counts (the last sum carried up a level), P = 2, mod p."""
    from uzkge_tpu.parallel.sharded import _fold_device_sums
    from uzkge_tpu_torch.parallel.sharded import fold_device_sums

    from .test_torch_fixed_base_query import _fq_vals, _mod_p, _port, _rows

    rs = np.random.default_rng(k)
    X, Y, Z = (_rows(_fq_vals(rs, k * 2), (k, 2)) for _ in range(3))
    stacked = np.stack([np.moveaxis(tf.to_jax_limbs(torch.stack([X[i], Y[i], Z[i]])), -1, 1)
                        for i in range(k)])  # (k, 3, 16, P)
    want = _fold_device_sums(stacked)
    for g, w in zip(fold_device_sums(X, Y, Z), want):
        assert g.shape == (2, 8) and _mod_p(g) == _mod_p(_port(w))
