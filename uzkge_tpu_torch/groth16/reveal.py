"""Groth16 reveal statement: sk*G = pk  AND  sk*e1 = reveal.

Parity target: the reference's `RevealCircuit` (shuffle/src/
reveal_with_snark.rs:85-140) proven with ark-groth16 and verified on-chain by
`RevealVerifier.verifyRevealWithSnark` (contracts/shuffle/RevealVerifier.sol:
52-57).  Public-input order is fixed by the deployed contract:

    [e1.x, e1.y, reveal.x, reveal.y, pk.x, pk.y]        (RevealVerifier.sol:53)

The circuit arithmetic is BabyJubjub (twisted Edwards, a=1) over BN254 Fr —
the R1CS base field — using complete Edwards addition so no branch logic is
needed in-circuit:

  fixed base  (G constant):  per scalar bit, the selected window point
      (bit*Gx_i, 1 + bit*(Gy_i - 1)) is LINEAR in the bit, so a conditional
      add costs only the 7 addition constraints.
  variable base (e1 instance): double-and-conditional-add; the doubling saves
      one product (x1*y2 == y1*x2), and the conditional select reuses the
      R1CS `select` gadget on each output coordinate.

Two proving paths:

  * `prove_reveal` — OUR circuit shape (this module's gadgets, ~7 constraints
    per conditional add) with our own deterministic setup.  Compact, but not
    interchangeable with the reference deployment.
  * `prove_reveal_onchain` — the reference-interoperable path: replays
    ark-r1cs-std 0.4's exact gate layout (groth16/ark_r1cs.py) and proves
    with the reference's embedded `groth16_pk.bin` (groth16/ark_pk.py), so
    the resulting proof is accepted by the DEPLOYED `Groth16Verifier.sol`
    (its vk constants equal the embedded pk's vk — tests/test_groth16_ark.py
    executes the unchanged contract over our proof bytes).

A copy of `uzkge_tpu/groth16/reveal.py`, except that both proving paths
take a `device` for their NTTs and G1 MSMs (the card by default, see
device.py::resolve).
"""

from typing import List, Optional, Tuple

from ..constants.bn254 import R_MOD, BJJ_GENERATOR, EDWARDS_D
from ..curve import babyjubjub as bjj
from ..device import resolve
from ..utils.chacha import ChaCha20Rng
from ..utils.stagetimer import stage
from .groth16 import Groth16Pk, Groth16Proof, prove, setup, verify
from .r1cs import LC, R1CS

P = R_MOD
D = EDWARDS_D

# BabyJubjub scalar field is 251 bits; ark iterates 256 LE bits but the top
# bits of a reduced scalar are always 0, so 251 suffices for soundness here.
SK_BITS = 251

_PK_CACHE: dict = {}


def _edwards_add_constraints(cs: R1CS, x1: LC, y1: LC, x2: LC, y2: LC,
                             val1: Tuple[int, int], val2: Tuple[int, int]):
    """Allocate (x3, y3) = (x1,y1) + (x2,y2) with complete a=1 formulas:
    x3 = (x1 y2 + y1 x2)/(1 + d x1 x2 y1 y2), y3 = (y1 y2 - x1 x2)/(1 - d ...).
    Returns (x3_var, y3_var, value)."""
    t1 = cs.mul(x1, y2)
    t2 = cs.mul(y1, x2)
    t3 = cs.mul(x1, x2)
    t4 = cs.mul(y1, y2)
    t5 = cs.mul(cs.lc((1, t3)), cs.lc((1, t4)))
    v3 = bjj.add(val1, val2)
    x3 = cs.new_witness(v3[0])
    y3 = cs.new_witness(v3[1])
    cs.enforce(cs.lc((1, 0), (D, t5)), cs.lc((1, x3)), cs.lc((1, t1), (1, t2)))
    cs.enforce(cs.lc((1, 0), (P - D, t5)), cs.lc((1, y3)), cs.lc((1, t4), (P - 1, t3)))
    return x3, y3, v3


def _edwards_double_constraints(cs: R1CS, x1: LC, y1: LC, val: Tuple[int, int]):
    """(x3,y3) = 2*(x1,y1): x3 = 2 x1 y1 / (1 + d x1^2 y1^2),
    y3 = (y1^2 - x1^2)/(1 - d x1^2 y1^2) — one product fewer than a full add."""
    t1 = cs.mul(x1, y1)
    t3 = cs.mul(x1, x1)
    t4 = cs.mul(y1, y1)
    t5 = cs.mul(cs.lc((1, t3)), cs.lc((1, t4)))
    v3 = bjj.double(val)
    x3 = cs.new_witness(v3[0])
    y3 = cs.new_witness(v3[1])
    cs.enforce(cs.lc((1, 0), (D, t5)), cs.lc((1, x3)), cs.lc((2, t1)))
    cs.enforce(cs.lc((1, 0), (P - D, t5)), cs.lc((1, y3)), cs.lc((1, t4), (P - 1, t3)))
    return x3, y3, v3


def reveal_circuit(sk: int, e1, reveal_pt=None, pk=None) -> R1CS:
    """Build (and assign) the reveal R1CS.  reveal_pt/pk default to the values
    implied by sk, matching RevealCircuit::new (reveal_with_snark.rs:92-107)."""
    sk %= bjj.ORDER
    if pk is None:
        pk = bjj.mul(BJJ_GENERATOR, sk)
    if reveal_pt is None:
        reveal_pt = bjj.mul(e1, sk)

    cs = R1CS()
    # instance layout fixed by RevealVerifier.sol:53
    i_e1x = cs.new_instance(e1[0])
    i_e1y = cs.new_instance(e1[1])
    i_rx = cs.new_instance(reveal_pt[0])
    i_ry = cs.new_instance(reveal_pt[1])
    i_pkx = cs.new_instance(pk[0])
    i_pky = cs.new_instance(pk[1])

    bits = [(sk >> i) & 1 for i in range(SK_BITS)]
    bit_vars = []
    for b in bits:
        v = cs.new_witness(b)
        cs.enforce_boolean(v)
        bit_vars.append(v)

    one = cs.lc((1, 0))

    # --- fixed-base: acc = sum bit_i * 2^i G ------------------------------
    acc_x, acc_y = LC(), one          # identity (0, 1)
    acc_val = bjj.IDENTITY
    g_pow = BJJ_GENERATOR
    for i, bv in enumerate(bit_vars):
        gx, gy = g_pow
        # selected point is linear in the bit: (bit*gx, 1 + bit*(gy-1))
        px = cs.lc((gx, bv))
        py = cs.lc((1, 0), ((gy - 1) % P, bv))
        pval = g_pow if bits[i] else bjj.IDENTITY
        x3, y3, acc_val = _edwards_add_constraints(
            cs, acc_x, acc_y, px, py, acc_val, pval)
        acc_x, acc_y = cs.lc((1, x3)), cs.lc((1, y3))
        g_pow = bjj.double(g_pow)
    cs.enforce_equal(acc_x, cs.lc((1, i_pkx)))
    cs.enforce_equal(acc_y, cs.lc((1, i_pky)))

    # --- variable-base: acc = sk * e1 -------------------------------------
    acc_x, acc_y = LC(), one
    acc_val = bjj.IDENTITY
    cur_x, cur_y = cs.lc((1, i_e1x)), cs.lc((1, i_e1y))
    cur_val = e1
    for i, bv in enumerate(bit_vars):
        sx, sy, s_val = _edwards_add_constraints(
            cs, acc_x, acc_y, cur_x, cur_y, acc_val, cur_val)
        nx = cs.select(bv, cs.lc((1, sx)), acc_x)
        ny = cs.select(bv, cs.lc((1, sy)), acc_y)
        acc_val = s_val if bits[i] else acc_val
        acc_x, acc_y = cs.lc((1, nx)), cs.lc((1, ny))
        if i + 1 < SK_BITS:
            dx, dy, cur_val = _edwards_double_constraints(cs, cur_x, cur_y, cur_val)
            cur_x, cur_y = cs.lc((1, dx)), cs.lc((1, dy))
    cs.enforce_equal(acc_x, cs.lc((1, i_rx)))
    cs.enforce_equal(acc_y, cs.lc((1, i_ry)))
    return cs


def reveal_setup() -> Groth16Pk:
    """Deterministic proving key for the reveal circuit shape (cached).
    Production deployments replace this with an MPC ceremony; the reference's
    analogue artifact is shuffle/parameters/groth16_pk.bin."""
    pk = _PK_CACHE.get("reveal")
    if pk is None:
        # any satisfied instance of the right shape works for setup
        cs = reveal_circuit(2, bjj.mul(BJJ_GENERATOR, 3))
        pk = setup(cs, seed=b"uzkge-tpu groth16 reveal")
        _PK_CACHE["reveal"] = pk
    return pk


def prove_reveal(sk: int, masked_e1, pk: Optional[Groth16Pk] = None,
                 rng: Optional[ChaCha20Rng] = None, device=None):
    """Returns (reveal_point, Groth16Proof) — sdk.rs:288-326's core."""
    if pk is None:
        pk = reveal_setup()
    sk %= bjj.ORDER
    reveal_pt = bjj.mul(masked_e1, sk)
    cs = reveal_circuit(sk, masked_e1, reveal_pt)
    return reveal_pt, prove(pk, cs, rng=rng, device=device)


def verify_reveal_snark(masked_e1, reveal_pt, player_pk,
                        proof: Groth16Proof, vk=None) -> bool:
    """RevealVerifier.verifyRevealWithSnark's statement (pi order :53)."""
    if vk is None:
        vk = reveal_setup().vk
    pi = [masked_e1[0], masked_e1[1], reveal_pt[0], reveal_pt[1],
          player_pk[0], player_pk[1]]
    return verify(vk, pi, proof)


# ------------------------------------------------------------------ interop
# Proofs for the DEPLOYED Groth16Verifier.sol, via the reference's embedded
# ark proving key (sdk.rs:288-326 `reveal_card_with_snark`).


def prove_reveal_onchain(sk: int, masked_e1, rng=None, device=None):
    """Returns (reveal_point, (A, B, C)) where the proof verifies under the
    deployed contract's vk.  A, C are G1 affine; B is G2 affine.  The
    witness map and the G1 and G2 MSMs run on `device` (the card by default)."""
    import random as _random

    from .ark_pk import load_reference_groth16_pk
    from .ark_prove import groth16_prove_with_pk
    from .ark_r1cs import synthesize_reveal

    dev = resolve(device)
    with stage("g16_synthesize"):
        sk %= bjj.ORDER
        reveal_pt = bjj.mul(masked_e1, sk)
        pk_pt = bjj.mul(BJJ_GENERATOR, sk)
        cs = synthesize_reveal(sk, masked_e1, reveal_pt, pk_pt)
    with stage("g16_pk_load"):
        apk = load_reference_groth16_pk()
    if rng is None:
        rng = _random.SystemRandom()
    r = rng.randrange(1, R_MOD)
    s = rng.randrange(1, R_MOD)
    proof = groth16_prove_with_pk(apk, cs.matrices(), cs.assignment(),
                                  cs.num_instance, r, s, device=dev)
    return reveal_pt, proof


def verify_reveal_onchain(masked_e1, reveal_pt, player_pk, proof) -> bool:
    """Pairing check under the embedded pk's vk (== the deployed contract's
    constants); public-input order per RevealVerifier.sol:53."""
    from .ark_pk import load_reference_groth16_pk
    from .ark_prove import groth16_verify_with_vk

    pi = [masked_e1[0], masked_e1[1], reveal_pt[0], reveal_pt[1],
          player_pk[0], player_pk[1]]
    return groth16_verify_with_vk(load_reference_groth16_pk().vk, proof, pi)


def seeded_reveal(rng):
    """A reproducible reveal: a player's secret key and the e1 = r*G of a
    card masked with a random r, drawn from `rng` in that order."""
    sk = rng.randrange(1, bjj.ORDER)
    return sk, bjj.mul(BJJ_GENERATOR, rng.randrange(1, bjj.ORDER))


def onchain_words(reveal_pt, proof) -> List[int]:
    """The calldata of RevealVerifier.verifyRevealWithSnark's proof and
    reveal point: [a.x, a.y, b.x.c1, b.x.c0, b.y.c1, b.y.c0, c.x, c.y,
    reveal.x, reveal.y] for a prove_reveal_onchain result."""
    A, B, C = proof
    return [A[0], A[1], B[0][1], B[0][0], B[1][1], B[1][0], C[0], C[1],
            reveal_pt[0], reveal_pt[1]]
