"""TurboPLONK prover: the 5-round Fiat-Shamir protocol on torch tensors.

Counterpart of `uzkge_tpu/plonk/prover.py` (reference prover.rs:88-394 and
helpers.rs), round for round, so that the same `rng` gives the same proof
bytes:

  * witness / selector / z polynomials: batched iFFTs on the device,
    Lagrange-basis commits through one batched MSM per round, blind factors
    on the host; with a KZG on a process group (`KZG(..., group=)`) the
    batched NTTs are sharded over its ranks (`_ntt_batch`), as the commits
    are;
  * the z grand product, the transcript and the openings' host arithmetic
    run in native host math (native_host.py, csrc/hostmath.c);
  * the quotient numerator is evaluated over the 8n coset by the 18-term
    expression of `_build_t_kernel` (helpers.rs:284-669), here in torch ops
    on the wide form of ff/field.py, then coset-iFFT'd back.

Randomness: the caller's `random.Random`; the proof is a deterministic
function of it.
"""

from typing import List

import torch
import torch.distributed as dist

from .. import native_host as nh
from ..constants.bn254 import R_MOD as P
from ..ff.field import fr, lift, lower
from ..ntt.ntt import get_domain
from ..parallel.sharded import sharded_ntt_batch
from ..utils.stagetimer import stage
from ..utils.transcript import Transcript
from .cs import N_WIRES_PER_GATE, TurboCS
from .helpers import alpha_powers, first_lagrange_eval, r_scalars
from .indexer import ProverParams


def transcript_init_plonk(transcript: Transcript, vk, pi_values: List[int], root: int):
    """(reference plonk/transcript.rs:8-31)"""
    transcript.append_message(b"PLONK")
    transcript.append_u64(vk.cs_size)
    transcript.append_message(P.to_bytes(32, "big"))
    for q in vk.cm_q_vec:
        transcript.append_commitment(q if q is not None else (0, 0))
    for s in vk.cm_s_vec:
        transcript.append_commitment(s if s is not None else (0, 0))
    transcript.append_field_elem(root)
    for k in vk.k:
        transcript.append_field_elem(k)
    for v in pi_values:
        transcript.append_field_elem(v)


# ------------------------------------------------------------- the t kernel


def _build_t_kernel(with_shuffle: bool, factor: int):
    """The quotient numerator times Z_H^-1 over the coset, as a function of
    wide tensors (W, ..., m) and wide constants (W, 1)."""
    mul, add, sub = fr.wmul, fr.wadd, fr.wsub

    def kernel(q, s, qb, prk, l1, zh_inv_tiled, coset, w, wsel, z, pi, c,
               q_ecc=None, gen=None, pk=None):
        one = c["one"]

        def rot(x):  # evaluation at w * X: shift by `factor` on the m-domain
            return torch.roll(x, -factor, dims=-1)

        w0, w1, w2, w3, w4 = (w[:, i] for i in range(5))
        wn0, wn1, wn2 = rot(w0), rot(w1), rot(w2)
        zn = rot(z)
        ap = c["ap"]
        qs = [q[:, i] for i in range(9)]

        # term 1: the gate equation
        t1 = mul(qs[0], w0)
        t1 = add(t1, mul(qs[1], w1))
        t1 = add(t1, mul(qs[2], w2))
        t1 = add(t1, mul(qs[3], w3))
        t1 = add(t1, mul(qs[4], mul(w0, w1)))
        t1 = add(t1, mul(qs[5], mul(w2, w3)))
        t1 = add(t1, qs[6])
        t1 = add(t1, pi)
        prod = mul(mul(mul(mul(w0, w1), w2), w3), w4)
        t1 = add(t1, mul(qs[7], prod))
        t1 = sub(t1, mul(qs[8], w4))

        # term 2: alpha * z * prod_j (w_j + beta*k_j*coset + gamma)
        bg = c["beta"]
        t2 = mul(ap[1], z)
        for j in range(5):
            fac = add(add(w[:, j], c["gamma"]), mul(bg, mul(c["k"][j], coset)))
            t2 = mul(t2, fac)
        # term 3: alpha * z_next * prod_j (w_j + beta*s_j + gamma)
        t3 = mul(ap[1], zn)
        for j in range(5):
            fac = add(add(w[:, j], c["gamma"]), mul(bg, s[:, j]))
            t3 = mul(t3, fac)
        # term 4: alpha^2 * L1 * (z - 1)
        t4 = mul(mul(ap[2], l1), sub(z, one))
        # boolean terms 5-7
        t5 = mul(mul(ap[3], qb), mul(w1, sub(w1, one)))
        t6 = mul(mul(ap[4], qb), mul(w2, sub(w2, one)))
        t7 = mul(mul(ap[5], qb), mul(w3, sub(w3, one)))

        # Anemoi terms 8-11
        g, ginv, g2p1 = c["g"], c["g_inv"], c["g2p1"]
        w3w0 = add(w0, w3)
        w2w1 = add(w1, w2)
        w32w0 = add(w0, w3w0)
        w22w1 = add(w1, w2w1)

        def pow5(x):
            x2 = mul(x, x)
            return mul(mul(x2, x2), x)

        prk0, prk1, prk2, prk3 = (prk[:, i] for i in range(4))
        tmp = add(add(w3w0, mul(g, w2w1)), prk2)
        t8 = mul(mul(ap[6], prk2),
                 sub(add(pow5(sub(tmp, wn2)), mul(g, mul(tmp, tmp))),
                     add(add(w32w0, mul(g, w22w1)), prk0)))
        t10 = mul(mul(ap[8], prk2),
                  sub(add(add(pow5(sub(tmp, wn2)), mul(g, mul(wn2, wn2))), ginv), wn0))
        tmp2 = add(add(mul(g, w3w0), mul(g2p1, w2w1)), prk3)
        t9 = mul(mul(ap[7], prk2),
                 sub(add(pow5(sub(tmp2, w4)), mul(g, mul(tmp2, tmp2))),
                     add(add(mul(g, w32w0), mul(g2p1, w22w1)), prk1)))
        t11 = mul(mul(ap[9], prk2),
                  sub(add(add(pow5(sub(tmp2, w4)), mul(g, mul(w4, w4))), ginv), wn1))

        numerator = add(t1, t2)
        numerator = add(numerator, sub(t4, t3))
        numerator = add(add(add(numerator, t5), t6), t7)
        numerator = sub(sub(sub(sub(numerator, t8), t9), t10), t11)

        if with_shuffle:
            ws0, ws1, ws2 = (wsel[:, i] for i in range(3))
            a = c["edwards_a"]
            one_m_ws0 = sub(one, ws0)
            one_m_ws1 = sub(one, ws1)
            sel = [
                sub(add(mul(one_m_ws0, one_m_ws1), q_ecc), one),
                mul(ws0, one_m_ws1),
                mul(one_m_ws0, ws1),
                mul(ws0, ws1),
            ]

            def quad(u, v, un, X, Y, DXY, plus_a):
                uvun = mul(mul(u, v), un)
                if not plus_a:
                    # ws2*un - ws2*u*Y - v*X + u*v*un*DXY
                    r = sub(mul(ws2, un), mul(ws2, mul(u, Y)))
                    r = sub(r, mul(v, X))
                    return add(r, mul(uvun, DXY))
                # ws2*un + a*u*X - ws2*v*Y - u*v*un*DXY
                r = add(mul(ws2, un), mul(a, mul(u, X)))
                r = sub(r, mul(ws2, mul(v, Y)))
                return sub(r, mul(uvun, DXY))

            def term(apw, u, v, un, tab, plus_a):
                acc = None
                for t in range(4):
                    X, Y, DXY = tab[:, t], tab[:, 4 + t], tab[:, 8 + t]
                    q_ = mul(sel[t], quad(u, v, un, X, Y, DXY, plus_a))
                    acc = q_ if acc is None else add(acc, q_)
                return mul(apw, acc)

            t12 = term(ap[10], w0, w1, wn0, pk, False)
            t13 = term(ap[11], w0, w1, wn1, pk, True)
            t14 = term(ap[12], w2, w3, wn2, gen, False)
            t15 = term(ap[13], w2, w3, w4, gen, True)
            t16 = mul(ap[14], add(mul(mul(q_ecc, ws0), sub(one, ws0)), mul(sub(one, q_ecc), ws0)))
            t17 = mul(ap[15], add(mul(mul(q_ecc, ws1), sub(one, ws1)), mul(sub(one, q_ecc), ws1)))
            t18 = mul(ap[16], mul(q_ecc, mul(add(one, ws2), sub(one, ws2))))
            for t in (t12, t13, t14, t15, t16, t17, t18):
                numerator = add(numerator, t)

        return mul(numerator, zh_inv_tiled)

    return kernel


def t_coset_evals(pp: ProverParams, w_coset, wsel_coset, z_coset, pi_coset, challenges: dict,
                  with_shuffle: bool):
    """(m, 8) coset evaluations of the quotient polynomial t."""
    m = pp.m
    dev = w_coset.device
    kern = _build_t_kernel(with_shuffle, m // pp.n)
    vk = pp.verifier_params

    def const(v):  # wide (W, 1) constant(s) broadcasting over the m axis
        lim = fr.to_mont_limbs(v if isinstance(v, list) else [v], dev)
        return lift(lim)[..., None] if isinstance(v, list) else lift(lim)[:, 0, None]

    ap = const(alpha_powers(challenges["alpha"], 16))  # (W, 17, 1)
    ks = const(list(vk.k))
    c = {
        "one": const(1),
        "beta": const(challenges["beta"]),
        "gamma": const(challenges["gamma"]),
        "ap": [ap[:, i] for i in range(ap.shape[1])],
        "k": [ks[:, i] for i in range(ks.shape[1])],
        "g": const(vk.anemoi_generator),
        "g_inv": const(vk.anemoi_generator_inv),
        "g2p1": const((vk.anemoi_generator ** 2 + 1) % P),
        "edwards_a": const(vk.edwards_a if with_shuffle else 0),
    }
    args = dict(
        q=lift(pp.q_coset), s=lift(pp.s_coset), qb=lift(pp.qb_coset), prk=lift(pp.q_prk_coset),
        l1=lift(pp.l1_coset), zh_inv_tiled=lift(pp.z_h_inv_coset.repeat(pp.n, 1)),
        coset=lift(pp.coset_elems), w=lift(w_coset), wsel=lift(wsel_coset), z=lift(z_coset),
        pi=lift(pi_coset), c=c,
    )
    if with_shuffle:
        args.update(q_ecc=lift(pp.q_ecc_coset), gen=lift(pp.q_gen_coset), pk=lift(pp.q_pk_coset))
    return lower(kern(**args))


# ------------------------------------------------------------------- prover


def _hide(coefs, blinds: List[int], n: int):
    """p + sum b_i X^i - sum b_i X^{n+i}: an (n + h, 8) tensor."""
    h = len(blinds)
    badd = fr.to_mont_limbs(blinds, coefs.device)
    tail = fr.to_mont_limbs([(-b) % P for b in blinds], coefs.device)
    head = fr.add(coefs[:h], badd)
    return torch.cat([head, coefs[h:], tail], dim=0)


def _pad_stack(polys, m: int):
    """Zero-pad (len_i, 8) polynomials to m rows and stack them."""
    out = torch.zeros((len(polys), m, 8), dtype=torch.int32, device=polys[0].device)
    for i, p in enumerate(polys):
        out[i, : p.shape[0]] = p
    return out


def _ntt_batch(kzg, dom, x, inverse: bool = False, coset_k: int = None):
    """A batched (i)NTT of (B, m, 8) (`_mesh_ntt_batch`): through
    parallel/sharded.py::sharded_ntt_batch when the KZG has a process group,
    the batch zero-padded to a multiple of the world size and trimmed after;
    else the domain's own batched NTT."""
    if kzg.group is None:
        if coset_k is not None:
            return dom.coset_ifft_batch(x, coset_k) if inverse else dom.coset_fft_batch(x, coset_k)
        return dom.ifft_batch(x) if inverse else dom.fft_batch(x)
    ws, B = dist.get_world_size(kzg.group), x.shape[0]
    pad = -B % ws
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
    return sharded_ntt_batch(kzg.group, x, inverse=inverse, coset_k=coset_k)[:B]


def _fetch_blobs(arrays):
    """One device-to-host copy for many (m_i, 8) Montgomery tensors; returns
    their standard-form 32-byte LE blobs."""
    lens = [a.shape[0] for a in arrays]
    blob = fr.from_mont_bytes(torch.cat(arrays, dim=0))
    out = []
    off = 0
    for m in lens:
        out.append(blob[off * 32 : (off + m) * 32])
        off += m
    return out


def _pp_coef_blobs(pp) -> dict:
    """Byte blobs of the proving key's coefficient polynomials, fetched once
    per ProverParams and cached on it."""
    got = getattr(pp, "_coef_blob_cache", None)
    if got is None:
        arrays = [pp.q_coefs.reshape(-1, 8), pp.qb_coefs,
                  pp.q_prk_coefs.reshape(-1, 8), pp.s_coefs.reshape(-1, 8)]
        if pp.with_shuffle:
            arrays += [pp.q_pk_coefs.reshape(-1, 8),
                       pp.q_gen_coefs.reshape(-1, 8), pp.q_ecc_coefs]
        blobs = _fetch_blobs(arrays)
        n32 = pp.n * 32

        def split(b, k):
            return [b[i * n32 : (i + 1) * n32] for i in range(k)]

        got = {
            "q": split(blobs[0], 9),
            "qb": blobs[1],
            "prk": split(blobs[2], 4),
            "s": split(blobs[3], 5),
        }
        if pp.with_shuffle:
            got["q_pk"] = split(blobs[4], 12)
            got["q_gen"] = split(blobs[5], 12)
            got["q_ecc"] = blobs[6]
        object.__setattr__(pp, "_coef_blob_cache", got)
    return got


def prover(rng, transcript: Transcript, kzg, cs: TurboCS, pp: ProverParams,
           witness: List[int]) -> dict:
    """Produce a PlonkProof dict (field names mirror indexer.rs:33-73)."""
    with_shuffle = pp.with_shuffle
    n = pp.n
    m = pp.m
    vk = pp.verifier_params
    dev = kzg.device
    dom = get_domain(n, dev)
    dom_m = get_domain(m, dev)
    root = dom.omega
    k1 = vk.k[1]

    online_values = [witness[i] for i in cs.public_vars_witness_indices]
    transcript_init_plonk(transcript, vk, online_values, root)
    challenges = {}

    def rand_fr():
        return rng.randrange(P)

    def commit_evals_with_blinds(evals_batch, blinds_per_poly, blinded_polys=None):
        if kzg.lagrange_n == n:
            cms = kzg.commit_evals_batch(evals_batch)
            return [
                kzg.apply_blind_factors(cm, blinds, n)
                for cm, blinds in zip(cms, blinds_per_poly)
            ]
        # coefficient fallback (small circuits on the padded SRS prefix)
        assert blinded_polys is not None
        return [kzg.commit_coefs(fr.from_mont_limbs(p)) for p in blinded_polys]

    # --- round 1: witness (and shuffle witness-selector) polynomials; both
    # commit batches ride one batched MSM
    with stage("r1_witness_host"):
        extended = cs.extend_witness(witness)
        w_evals = fr.to_mont_limbs(extended, dev).reshape(N_WIRES_PER_GATE, n, 8)
        if with_shuffle:
            wsel_rows = cs.compute_witness_selectors()
            wsel_flat = [v for row in wsel_rows for v in row]
            wsel_evals = fr.to_mont_limbs(wsel_flat, dev).reshape(3, n, 8)
    with stage("r1_ifft", block=w_evals):
        w_coefs = _ntt_batch(kzg, dom, w_evals, inverse=True)
        w_blinds = [[rand_fr() for _ in range(hd)] for hd in (3, 3, 3, 2, 2)]
        w_polys = [_hide(w_coefs[i], w_blinds[i], n) for i in range(5)]
        w_sel_polys = []
        if with_shuffle:
            wsel_coefs = _ntt_batch(kzg, dom, wsel_evals, inverse=True)
            wsel_blinds = [[rand_fr(), rand_fr()] for _ in range(3)]
            w_sel_polys = [_hide(wsel_coefs[i], wsel_blinds[i], n) for i in range(3)]
    cm_w_sel_vec = []
    with stage("r1_commit"):
        if with_shuffle and kzg.lagrange_n == n:
            cms = kzg.commit_evals_batch(torch.cat([w_evals, wsel_evals], dim=0))
            cm_w_vec = [kzg.apply_blind_factors(cm, b, n) for cm, b in zip(cms[:5], w_blinds)]
            cm_w_sel_vec = [kzg.apply_blind_factors(cm, b, n)
                            for cm, b in zip(cms[5:], wsel_blinds)]
        else:
            cm_w_vec = commit_evals_with_blinds(w_evals, w_blinds, w_polys)
            if with_shuffle:
                cm_w_sel_vec = commit_evals_with_blinds(wsel_evals, wsel_blinds, w_sel_polys)
    for cm in cm_w_vec:
        transcript.append_commitment(cm)
    for cm in cm_w_sel_vec:
        transcript.append_commitment(cm)

    # --- round 2: beta, gamma, the z polynomial
    beta = transcript.get_challenge(P)
    transcript.append_single_byte(0x01)
    gamma = transcript.get_challenge(P)
    challenges["beta"], challenges["gamma"] = beta, gamma

    with stage("r2_z_host"):
        witness_blob = b"".join(int(v).to_bytes(32, "little") for v in extended)
        if not pp.group_blob:
            pp.group_blob = b"".join(int(v).to_bytes(32, "little") for v in pp.group)
        z_blob = nh.z_poly_bytes(
            witness_blob, pp.permutation, pp.group_blob, vk.k, beta, gamma, n
        )
        z_evals = fr.to_mont_limbs_from_bytes(z_blob, dev)
    with stage("r2_ifft", block=z_evals):
        z_coefs = dom.ifft(z_evals)
        z_blinds = [rand_fr() for _ in range(3)]
        z_poly = _hide(z_coefs, z_blinds, n)
    with stage("r2_commit"):
        cm_z = commit_evals_with_blinds(z_evals[None], [z_blinds], [z_poly])[0]
    transcript.append_commitment(cm_z)

    # --- round 3: alpha, the t polynomial
    alpha = transcript.get_challenge(P)
    challenges["alpha"] = alpha

    with stage("r3_coset_ffts"):
        pi_evals = [0] * n
        for pos, ci in enumerate(vk.public_vars_constraint_indices):
            pi_evals[ci] = online_values[pos]
        pi_coefs = dom.ifft(fr.to_mont_limbs(pi_evals, dev))
        w_coset = _ntt_batch(kzg, dom_m, _pad_stack(w_polys, m), coset_k=k1)
        if with_shuffle:
            wsel_coset = _ntt_batch(kzg, dom_m, _pad_stack(w_sel_polys, m), coset_k=k1)
        else:
            wsel_coset = torch.zeros((3, m, 8), dtype=torch.int32, device=dev)
        z_coset = dom_m.coset_fft(z_poly, k1)
        pi_coset = dom_m.coset_fft(pi_coefs, k1)
    with stage("r3_t_kernel", block=pi_coset):
        t_evals = t_coset_evals(pp, w_coset, wsel_coset, z_coset, pi_coset, challenges,
                                with_shuffle)
    with stage("r3_t_ifft", block=t_evals):
        t_coefs = dom_m.coset_ifft(t_evals, k1)
    with stage("r3_t_from_mont", block=t_coefs):
        t_blob = fr.from_mont_bytes(t_coefs)
    nt_len = len(t_blob) // 32
    while nt_len > 0 and t_blob[(nt_len - 1) * 32 : nt_len * 32] == b"\x00" * 32:
        nt_len -= 1
    t_blob = t_blob[: nt_len * 32]

    def blob_coef(blob, i):
        return int.from_bytes(blob[i * 32 : (i + 1) * 32], "little")

    def set_blob_coef(blob, i, v):
        blob[i * 32 : (i + 1) * 32] = int(v).to_bytes(32, "little")

    # split into 5 chunks of (n + 2) coefficients and commit them
    # (helpers.rs:1323-1408); the Lagrange-path chunks ride one batched MSM
    with stage("r3_t_split_commit"):
        nt = n + 2
        t_chunk_blobs = []
        prev_blind = 0
        pending = []  # (idx, head_bytes, blinds, max_pow2) on the Lagrange path
        cm_t_vec = [None] * N_WIRES_PER_GATE
        for i in range(N_WIRES_PER_GATE):
            start_c = i * nt
            end_c = nt_len if i == N_WIRES_PER_GATE - 1 else (i + 1) * nt
            chunk = bytearray(t_blob[start_c * 32 : max(start_c, end_c) * 32])
            b = rand_fr()
            if i != N_WIRES_PER_GATE - 1:
                chunk += b"\x00" * ((nt + 1) * 32 - len(chunk))
                set_blob_coef(chunk, nt, (blob_coef(chunk, nt) + b) % P)
                set_blob_coef(chunk, 0, (blob_coef(chunk, 0) - prev_blind) % P)
            elif not chunk:
                chunk = bytearray(((-prev_blind) % P).to_bytes(32, "little"))
            else:
                set_blob_coef(chunk, 0, (blob_coef(chunk, 0) - prev_blind) % P)
            prev_blind = b
            cl = len(chunk) // 32
            while cl > 1 and chunk[(cl - 1) * 32 : cl * 32] == b"\x00" * 32:
                cl -= 1
            chunk = bytes(chunk[: cl * 32])
            degree = cl - 1
            max_pow2 = degree
            for j in range(degree, -1, -1):
                if j & (j - 1) == 0:
                    max_pow2 = j
                    break
            if kzg.lagrange_n == max_pow2:
                blinds = [(-blob_coef(chunk, j)) % P for j in range(max_pow2, cl)]
                head = bytearray(chunk[: max_pow2 * 32])
                for j, v in enumerate(blinds):
                    set_blob_coef(head, j, (blob_coef(head, j) - v) % P)
                pending.append((i, bytes(head), blinds, max_pow2))
            else:
                cm_t_vec[i] = kzg.commit_coefs([blob_coef(chunk, j) for j in range(cl)])
            t_chunk_blobs.append(chunk)
        if pending:
            mp = pending[0][3]
            heads = torch.stack([fr.to_mont_limbs_from_bytes(h, dev) for _, h, _, _ in pending])
            cms = kzg.commit_evals_batch(get_domain(mp, dev).fft_batch(heads))
            for (i, _, blinds, mpc), cm in zip(pending, cms):
                cm_t_vec[i] = kzg.apply_blind_factors(cm, blinds, mpc)
    for cm in cm_t_vec:
        transcript.append_commitment(cm)

    # --- round 4: zeta, evaluations (native Horner over byte blobs)
    zeta = transcript.get_challenge(P)
    challenges["zeta"] = zeta
    zeta_omega = zeta * root % P

    with stage("r4_from_mont"):
        static = _pp_coef_blobs(pp)
        s_coef_blobs = static["s"]
        prk_coef_blobs = static["prk"]
        per_proof = _fetch_blobs(list(w_polys) + [z_poly] + list(w_sel_polys))
        w_poly_blobs = per_proof[:5]
        z_poly_blob = per_proof[5]
        w_sel_poly_blobs = per_proof[6:]

    with stage("r4_horner"):
        w_polys_eval_zeta = [nh.horner_eval_bytes(b, zeta) for b in w_poly_blobs]
        s_polys_eval_zeta = [nh.horner_eval_bytes(s_coef_blobs[i], zeta) for i in range(4)]
        prk_3_poly_eval_zeta = nh.horner_eval_bytes(prk_coef_blobs[2], zeta)
        prk_4_poly_eval_zeta = nh.horner_eval_bytes(prk_coef_blobs[3], zeta)
        z_eval_zeta_omega = nh.horner_eval_bytes(z_poly_blob, zeta_omega)
        w_polys_eval_zeta_omega = [nh.horner_eval_bytes(w_poly_blobs[i], zeta_omega)
                                   for i in range(3)]
        if with_shuffle:
            q_ecc_blob = static["q_ecc"]
            q_ecc_poly_eval_zeta = nh.horner_eval_bytes(q_ecc_blob, zeta)
            w_sel_polys_eval_zeta = [nh.horner_eval_bytes(b, zeta) for b in w_sel_poly_blobs]

    for ev in w_polys_eval_zeta + s_polys_eval_zeta:
        transcript.append_field_elem(ev)
    if with_shuffle:
        for ev in w_sel_polys_eval_zeta:
            transcript.append_field_elem(ev)
    transcript.append_field_elem(prk_3_poly_eval_zeta)
    transcript.append_field_elem(prk_4_poly_eval_zeta)
    transcript.append_field_elem(z_eval_zeta_omega)
    if with_shuffle:
        transcript.append_field_elem(q_ecc_poly_eval_zeta)
    for ev in w_polys_eval_zeta_omega:
        transcript.append_field_elem(ev)

    # --- round 5: u, the linearization polynomial, openings
    u = transcript.get_challenge(P)
    challenges["u"] = u

    z_h_eval_zeta, l1_eval_zeta = first_lagrange_eval(zeta, n)
    scalars = r_scalars(
        vk, w_polys_eval_zeta, s_polys_eval_zeta, prk_3_poly_eval_zeta, z_eval_zeta_omega,
        challenges, l1_eval_zeta, z_h_eval_zeta, n + 2, N_WIRES_PER_GATE,
        w_sel_evals_zeta=w_sel_polys_eval_zeta if with_shuffle else None,
        q_ecc_eval_zeta=q_ecc_poly_eval_zeta if with_shuffle else None,
        w_evals_zeta_omega=w_polys_eval_zeta_omega if with_shuffle else None,
    )
    with stage("r5_r_poly"):
        rows = list(static["q"])
        rows.append(static["qb"])
        rows.append(prk_coef_blobs[0])
        rows.append(prk_coef_blobs[1])
        if with_shuffle:
            rows += static["q_pk"]
            rows += static["q_gen"]
        rows.append(s_coef_blobs[4])
        rows.append(z_poly_blob)
        rows += t_chunk_blobs
        maxlen = max(len(r) // 32 for r in rows)
        r_poly_blob = nh.lincomb_bytes(rows, scalars, maxlen)

    polys_to_open = list(w_poly_blobs) + s_coef_blobs[:4]
    polys_to_open.append(prk_coef_blobs[2])
    polys_to_open.append(prk_coef_blobs[3])
    if with_shuffle:
        polys_to_open.append(q_ecc_blob)
        polys_to_open += w_sel_poly_blobs
    polys_to_open.append(r_poly_blob)

    with stage("r5_openings"):
        opening_witness_zeta, opening_witness_zeta_omega = kzg.batch_prove_multi(
            transcript,
            [
                (polys_to_open, zeta),
                ([z_poly_blob, w_poly_blobs[0], w_poly_blobs[1], w_poly_blobs[2]],
                 zeta_omega),
            ],
            n + 2,
        )

    proof = {
        "cm_w_vec": cm_w_vec,
        "cm_t_vec": cm_t_vec,
        "cm_z": cm_z,
        "prk_3_poly_eval_zeta": prk_3_poly_eval_zeta,
        "prk_4_poly_eval_zeta": prk_4_poly_eval_zeta,
        "w_polys_eval_zeta": w_polys_eval_zeta,
        "w_polys_eval_zeta_omega": w_polys_eval_zeta_omega,
        "z_eval_zeta_omega": z_eval_zeta_omega,
        "s_polys_eval_zeta": s_polys_eval_zeta,
        "opening_witness_zeta": opening_witness_zeta,
        "opening_witness_zeta_omega": opening_witness_zeta_omega,
    }
    if with_shuffle:
        proof["cm_w_sel_vec"] = cm_w_sel_vec
        proof["q_ecc_poly_eval_zeta"] = q_ecc_poly_eval_zeta
        proof["w_sel_polys_eval_zeta"] = w_sel_polys_eval_zeta
    return proof
