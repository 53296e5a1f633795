"""PLONK indexer (preprocessing): prover and verifier parameters.

Counterpart of `uzkge_tpu/plonk/indexer.py` (reference indexer.rs:240-536):
the sigma, selector, boolean, Anemoi and shuffle polynomials of a circuit as
(rows, n, 8) Fr Montgomery coefficient tensors and their evaluations on the
8n coset k1*H' (rows, m, 8), all on the KZG object's device, with one batched
iFFT, one batched coset FFT and one batched Lagrange-basis commit.
"""

from dataclasses import dataclass, field as dc_field, fields
from typing import List, Optional

import numpy as np
import torch

from ..constants.bn254 import R_MOD
from ..device import resolve
from ..ff.field import fr, from_jax_limbs
from ..ntt.ntt import get_domain
from ..utils.chacha import choose_ks
from .cs import N_SELECTORS, N_WIRES_PER_GATE, TurboCS


@dataclass
class VerifierParams:
    """Host-side verifying key (reference PlonkVerifierParams,
    indexer.rs:153-193)."""

    cm_q_vec: List
    cm_s_vec: List
    cm_qb: object
    cm_prk_vec: List
    anemoi_generator: int
    anemoi_generator_inv: int
    k: List[int]
    cs_size: int
    public_vars_constraint_indices: List[int]
    lagrange_constants: List[int]
    with_shuffle: bool = True
    cm_q_ecc: object = None
    cm_shuffle_generator_vec: List = dc_field(default_factory=list)
    cm_shuffle_public_key_vec: List = dc_field(default_factory=list)
    edwards_a: int = 0


@dataclass
class ProverParams:
    """Proving key with its polynomials as tensors on one device
    (reference PlonkProverParams, indexer.rs:77-139, as stacked rows)."""

    verifier_params: VerifierParams
    permutation: List[int]
    n: int
    m: int
    q_coefs: torch.Tensor          # (9, n, 8)
    s_coefs: torch.Tensor          # (5, n, 8)
    qb_coefs: torch.Tensor         # (n, 8)
    q_prk_coefs: torch.Tensor      # (4, n, 8)
    q_coset: torch.Tensor          # (9, m, 8)
    s_coset: torch.Tensor          # (5, m, 8)
    qb_coset: torch.Tensor         # (m, 8)
    q_prk_coset: torch.Tensor      # (4, m, 8)
    l1_coset: torch.Tensor         # (m, 8)
    z_h_inv_coset: torch.Tensor    # (factor, 8)
    coset_elems: torch.Tensor      # (m, 8)  k1 * w_m^j
    with_shuffle: bool = True
    q_ecc_coefs: Optional[torch.Tensor] = None    # (n, 8)
    q_gen_coefs: Optional[torch.Tensor] = None    # (12, n, 8)
    q_pk_coefs: Optional[torch.Tensor] = None     # (12, n, 8)
    q_ecc_coset: Optional[torch.Tensor] = None
    q_gen_coset: Optional[torch.Tensor] = None
    q_pk_coset: Optional[torch.Tensor] = None
    group: List[int] = dc_field(default_factory=list)
    s_evals_host: List[List[int]] = dc_field(default_factory=list)
    group_blob: bytes = b""


def lagrange_constant(group_root: int, n: int, constraint_index: int) -> int:
    """c_j = w^j / n (closed form of helpers.rs:1170-1179's product)."""
    return pow(group_root, constraint_index, R_MOD) * pow(n, R_MOD - 2, R_MOD) % R_MOD


def encode_perm_value(perm_value: int, n: int, group: List[int], k: List[int]) -> int:
    """k_{perm//n} * w^{perm%n} (indexer.rs:196-208)."""
    return k[perm_value // n] * group[perm_value % n] % R_MOD


def indexer(cs: TurboCS, kzg, permutation=None, verifier_params: Optional[VerifierParams] = None,
            with_shuffle: bool = True) -> ProverParams:
    dev = kzg.device
    n = cs.size
    m = cs.quot_eval_dom_size()
    factor = m // n
    assert n * factor == m

    dom = get_domain(n, dev)
    dom_m = get_domain(m, dev)
    group = dom.elements()
    k = verifier_params.k if verifier_params is not None else choose_ks(R_MOD, N_WIRES_PER_GATE)
    k1 = k[1]
    no_verifier = verifier_params is None

    perm = permutation if permutation is not None else cs.compute_permutation()

    sigma_rows = []
    for i in range(N_WIRES_PER_GATE):
        sigma_rows.append([encode_perm_value(perm[i * n + j], n, group, k) for j in range(n)])
    selector_rows = [list(cs.selectors[i]) for i in range(N_SELECTORS)]
    qb_row = [0] * n
    for i in cs.boolean_constraint_indices:
        qb_row[i] = 1
    prk_rows = cs.compute_anemoi_jive_selectors()

    rows = sigma_rows + selector_rows + [qb_row] + prk_rows
    layout = {"s": (0, 5), "q": (5, 14), "qb": (14, 15), "prk": (15, 19)}
    if with_shuffle:
        q_ecc_row = [0] * n
        for i in cs.shuffle_remark_indices_only():
            for j in range(cs.n_iteration_shuffle_scalar_mul):
                q_ecc_row[i + j] = 1
        gen_rows = cs.compute_shuffle_generator_selectors()
        rows += [q_ecc_row] + gen_rows
        layout["ecc"] = (19, 20)
        layout["gen"] = (20, 32)

    flat = [v for row in rows for v in row]
    evals = fr.to_mont_limbs(flat, dev).reshape(len(rows), n, 8)
    coefs = dom.ifft_batch(evals)
    coset = dom_m.coset_fft_batch(coefs, k1)

    def rows_of(t, key):
        a, b = layout[key]
        return t[a:b]

    if no_verifier:
        if kzg.lagrange_n == n:
            cms = kzg.commit_evals_batch(evals)
        else:
            host_coefs = fr.from_mont_limbs(coefs.reshape(-1, 8))
            cms = [kzg.commit_coefs(host_coefs[r * n : (r + 1) * n]) for r in range(len(rows))]
        gen_cms = cms[layout["gen"][0] : layout["gen"][1]] if with_shuffle else []
        verifier_params = VerifierParams(
            cm_q_vec=cms[layout["q"][0] : layout["q"][1]],
            cm_s_vec=cms[layout["s"][0] : layout["s"][1]],
            cm_qb=cms[layout["qb"][0]],
            cm_prk_vec=cms[layout["prk"][0] : layout["prk"][1]],
            anemoi_generator=cs.anemoi_generator,
            anemoi_generator_inv=cs.anemoi_generator_inv,
            k=k,
            cs_size=n,
            public_vars_constraint_indices=list(cs.public_vars_constraint_indices),
            lagrange_constants=[lagrange_constant(dom.omega, n, ci)
                                for ci in cs.public_vars_constraint_indices],
            with_shuffle=with_shuffle,
            cm_q_ecc=cms[layout["ecc"][0]] if with_shuffle else None,
            cm_shuffle_generator_vec=gen_cms,
            # the generator's commitments stand in until the joint public key
            # is installed (indexer.rs:472-478, refresh_prover_params_public_key)
            cm_shuffle_public_key_vec=list(gen_cms),
            edwards_a=cs.edwards_a if with_shuffle else 0,
        )

    l1_evals = [n % R_MOD] + [0] * (n - 1)
    l1_coefs = dom.ifft(fr.to_mont_limbs(l1_evals, dev))
    l1_coset = dom_m.coset_fft(l1_coefs, k1)

    zh_vals = []
    wm_n = pow(dom_m.omega, n, R_MOD)
    mult = pow(k1, n, R_MOD)
    for _ in range(factor):
        zh_vals.append((mult - 1) % R_MOD)
        mult = mult * wm_n % R_MOD
    zh_inv = [pow(v, R_MOD - 2, R_MOD) for v in zh_vals]

    pp = ProverParams(
        verifier_params=verifier_params,
        permutation=perm,
        n=n,
        m=m,
        q_coefs=rows_of(coefs, "q"),
        s_coefs=rows_of(coefs, "s"),
        qb_coefs=coefs[layout["qb"][0]],
        q_prk_coefs=rows_of(coefs, "prk"),
        q_coset=rows_of(coset, "q"),
        s_coset=rows_of(coset, "s"),
        qb_coset=coset[layout["qb"][0]],
        q_prk_coset=rows_of(coset, "prk"),
        l1_coset=l1_coset,
        z_h_inv_coset=fr.to_mont_limbs(zh_inv, dev),
        coset_elems=fr.to_mont_limbs([k1 * w % R_MOD for w in dom_m.elements()], dev),
        with_shuffle=with_shuffle,
        group=group,
        s_evals_host=sigma_rows,
    )
    if with_shuffle:
        pp.q_ecc_coefs = coefs[layout["ecc"][0]]
        pp.q_gen_coefs = rows_of(coefs, "gen")
        pp.q_pk_coefs = pp.q_gen_coefs  # stands in until the public-key refresh
        pp.q_ecc_coset = coset[layout["ecc"][0]]
        pp.q_gen_coset = rows_of(coset, "gen")
        pp.q_pk_coset = pp.q_gen_coset
    return pp


def refresh_prover_params_public_key(pp: ProverParams, cs: TurboCS, kzg, shuffle_pk):
    """Recompute the 12 q_shuffle_public_key polynomials after the joint
    public key changes (reference shuffle/src/gen_params/params.rs:57-129).
    Returns their 12 commitments."""
    cs.load_shuffle_remark_parameters(shuffle_pk)
    dev = kzg.device
    n, m = pp.n, pp.m
    dom, dom_m = get_domain(n, dev), get_domain(m, dev)
    k1 = pp.verifier_params.k[1]
    rows = cs.compute_shuffle_public_key_selectors()
    flat = [v for row in rows for v in row]
    evals = fr.to_mont_limbs(flat, dev).reshape(len(rows), n, 8)
    coefs = dom.ifft_batch(evals)
    coset = dom_m.coset_fft_batch(coefs, k1)
    if kzg.lagrange_n == n:
        cms = kzg.commit_evals_batch(evals)
    else:
        host_coefs = fr.from_mont_limbs(coefs.reshape(-1, 8))
        cms = [kzg.commit_coefs(host_coefs[r * n : (r + 1) * n]) for r in range(len(rows))]
    pp.q_pk_coefs = coefs
    pp.q_pk_coset = coset
    pp.verifier_params.cm_shuffle_public_key_vec = cms
    if hasattr(pp, "_coef_blob_cache"):  # the prover's static-blob cache is stale
        delattr(pp, "_coef_blob_cache")
    return cms


def verifier_params_from_jax(vk) -> VerifierParams:
    """A JAX-package VerifierParams (any object with the same fields) as this
    package's dataclass."""
    return VerifierParams(**{f.name: getattr(vk, f.name) for f in fields(VerifierParams)})


def prover_params_from_jax(pp, device=None) -> ProverParams:
    """A JAX-package ProverParams -> this package's, its arrays carried over
    through numpy onto `device` (16-bit limbs regrouped as 32-bit limbs)."""
    dev = resolve(device)
    kw = {}
    for f in fields(ProverParams):
        v = getattr(pp, f.name)
        if f.name == "verifier_params":
            v = verifier_params_from_jax(v)
        elif f.name in ("permutation", "group"):
            v = list(v)
        elif f.name == "s_evals_host":
            v = [list(r) for r in v]
        elif v is not None and not isinstance(v, (int, bool, bytes)):
            v = from_jax_limbs(np.asarray(v), dev)
        kw[f.name] = v
    return ProverParams(**kw)
