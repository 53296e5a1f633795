"""zmatchmaking on the torch prover: circuit, keys, prove, verify.

Counterpart of `uzkge_tpu/matchmaking/app.py` (reference
matchmaking/src/{matchmaking.rs, build_cs.rs}): a provably-fair Fisher-Yates
matchmaking circuit under the *generic* (non-shuffle) TurboPLONK protocol
shape, N = 50 players.  `generate_constraints` and `build_cs` are copies of
the host circuit code there.
"""

import random as _random
from typing import List, Tuple

from ..constants.bn254 import R_MOD as P
from ..hash.anemoi import eval_variable_length_hash_with_trace, eval_stream_cipher_with_trace
from ..plonk.cs import TurboCS
from ..plonk import gadgets as _gadgets  # noqa: F401
from ..plonk.indexer import indexer, ProverParams
from ..plonk.prover import prover
from ..plonk.verifier import verifier
from ..utils.stagetimer import stage
from ..utils.transcript import Transcript

PLONK_PROOF_TRANSCRIPT = b"Plonk Matchmaking Proof"
N = 50


def generate_constraints(cs: TurboCS, n: int, input_vars: List[int], committed_input_var: int,
                         committed_output_var: int, committed_trace, random_number_var: int):
    """Fisher-Yates in-circuit (matchmaking.rs:42-229)."""
    one = 1
    minus_one = P - 1

    indexes = [0, 1]
    index_vars = [cs.zero_var(), cs.one_var()]
    for i in range(2, n):
        idx = i % P
        iv = cs.new_variable(idx)
        cs.insert_constant_gate(iv, idx)
        indexes.append(idx)
        index_vars.append(iv)

    cs.anemoi_variable_length_hash(committed_trace, [committed_input_var], committed_output_var)

    sc_trace = eval_stream_cipher_with_trace(
        [committed_trace.input[0], cs.witness[random_number_var]], n - 1
    )
    sc_out_vars = [cs.new_variable(x) for x in sc_trace.output]
    cs.anemoi_stream_cipher(sc_trace, [committed_input_var, random_number_var], sc_out_vars)

    output_vars = list(input_vars)
    for i in range(1, n):
        nv = sc_trace.output[i - 1]
        q, r = divmod(nv, i + 1)
        n_var = cs.new_variable(nv)
        q_var = cs.new_variable(q)
        r_var = cs.new_variable(r)
        # div-rem gate: n = (i+1)*q + r
        cs.push_add_selectors((i + 1) % P, one, 0, 0)
        cs.push_mul_selectors(0, 0)
        cs.push_constant_selector(0)
        cs.push_ecc_selector(0)
        cs.push_out_selector(one)
        cs.wiring[0].append(q_var)
        cs.wiring[1].append(r_var)
        cs.wiring[2].append(cs.zero_var())
        cs.wiring[3].append(cs.zero_var())
        cs.wiring[4].append(n_var)
        cs.finish_new_gate()

        bits = [1 if (indexes[j] - r) % P == 0 else 0 for j in range(i + 1)]
        bits_vars = [cs.new_variable(b) for b in bits]

        # sum of bits equals 1 (with boolean constraints)
        sum_var = cs.zero_var()
        for c in range(0, len(bits_vars), 3):
            chunk = bits_vars[c : c + 3]
            if len(chunk) == 3:
                sum_var = cs.linear_combine([sum_var, chunk[0], chunk[1], chunk[2]], 1, 1, 1, 1)
            elif len(chunk) == 2:
                sum_var = cs.linear_combine([sum_var, chunk[0], chunk[1], cs.zero_var()], 1, 1, 1, 0)
            else:
                sum_var = cs.linear_combine([sum_var, chunk[0], cs.zero_var(), cs.zero_var()], 1, 1, 0, 0)
            cs.attach_boolean_constraint_to_gate()
        cs.insert_constant_gate(sum_var, 1)

        # (index - r) * bit = 0 gates
        for j in range(len(bits_vars)):
            cs.push_add_selectors(0, 0, 0, 0)
            cs.push_mul_selectors(one, minus_one)
            cs.push_constant_selector(0)
            cs.push_ecc_selector(0)
            cs.push_out_selector(0)
            cs.wiring[0].append(index_vars[j])
            cs.wiring[1].append(bits_vars[j])
            cs.wiring[2].append(r_var)
            cs.wiring[3].append(bits_vars[j])
            cs.wiring[4].append(cs.zero_var())
            cs.finish_new_gate()

        output_i_var = output_vars[i]
        bit_mul = [cs.mul(b, o) for b, o in zip(bits_vars, output_vars)]
        swap_var = cs.zero_var()
        for c in range(0, len(bit_mul), 3):
            chunk = bit_mul[c : c + 3]
            if len(chunk) == 3:
                swap_var = cs.linear_combine([swap_var, chunk[0], chunk[1], chunk[2]], 1, 1, 1, 1)
            elif len(chunk) == 2:
                swap_var = cs.linear_combine([swap_var, chunk[0], chunk[1], cs.zero_var()], 1, 1, 1, 0)
            else:
                swap_var = cs.linear_combine([swap_var, chunk[0], cs.zero_var(), cs.zero_var()], 1, 1, 0, 0)
        output_vars[i] = swap_var
        for j in range(i):
            output_vars[j] = cs.select(output_vars[j], output_i_var, bits_vars[j])
    return output_vars


def build_cs(inputs: List[int], committed_seed: int, random_number: int, n: int = N):
    """(build_cs.rs:27-66)"""
    cs = TurboCS()
    cs.load_anemoi_parameters()
    input_vars = [cs.new_variable(v) for v in inputs]
    random_number_var = cs.new_variable(random_number)
    committed_trace = eval_variable_length_hash_with_trace([committed_seed])
    committed_input_var = cs.new_variable(committed_seed)
    committed_output_var = cs.new_variable(committed_trace.output)

    output_vars = generate_constraints(
        cs, n, input_vars, committed_input_var, committed_output_var, committed_trace,
        random_number_var,
    )
    for v in input_vars:
        cs.prepare_pi_variable(v)
    for v in output_vars:
        cs.prepare_pi_variable(v)
    cs.prepare_pi_variable(random_number_var)
    cs.prepare_pi_variable(committed_output_var)
    cs.pad()
    return cs, output_vars


def seeded_match(rng, n: int = N) -> Tuple[List[int], int, int]:
    """A reproducible request: `n` player ids, the committed seed and the
    random number, all drawn from `rng`."""
    inputs = [rng.randrange(P) for _ in range(n)]
    return inputs, rng.randrange(P), rng.randrange(P)


def gen_matchmaking_prover_params(n: int = N, device=None, fixed_base=None, group=None):
    """(matchmaking/src/gen_params/params.rs:29-54)  Returns (pp, cs, kzg),
    with the proving key's tensors on `device` and the KZG's commit route
    set by `fixed_base` and `group` (see pcs/kzg.py::KZG)."""
    from ..gen_params import load_srs, load_matchmaking_verifier_params

    rng = _random.Random(0)
    inputs = [rng.randrange(P) for _ in range(n)]
    cs, _ = build_cs(inputs, rng.randrange(P), rng.randrange(P), n)
    kzg = load_srs(cs.size, device, fixed_base, group)
    # The reference's embedded matchmaking vk is stale (8 of 9 selector
    # commitments — see load_matchmaking_verifier_params); mirror the
    # reference's load-or-regenerate fallback (gen_params/params.rs:44-48).
    vk = None
    if n == N:
        from ..errors import MissingVerifierParamsError

        try:
            vk = load_matchmaking_verifier_params()
        except MissingVerifierParamsError:
            vk = None
    pp = indexer(cs, kzg, verifier_params=vk, with_shuffle=False)
    return pp, cs, kzg


def prove_matchmaking(rng, inputs: List[int], committed_seed: int, random_number: int,
                      pp: ProverParams, kzg, n: int = N) -> Tuple[dict, List[int]]:
    """(build_cs.rs:68-99)"""
    assert len(inputs) == n
    with stage("r0_build_cs"):
        cs, output_vars = build_cs(inputs, committed_seed, random_number, n)
        witness = cs.get_and_clear_witness()
    transcript = Transcript(PLONK_PROOF_TRANSCRIPT)
    transcript.append_u64(n)
    proof = prover(rng, transcript, kzg, cs, pp, witness)
    return proof, [witness[v] for v in output_vars]


def verify_matchmaking(vk, kzg, inputs: List[int], outputs: List[int], commitment: int,
                       random_number: int, proof: dict, n: int = N) -> bool:
    """(build_cs.rs:101-129)"""
    transcript = Transcript(PLONK_PROOF_TRANSCRIPT)
    transcript.append_u64(n)
    online = list(inputs) + list(outputs) + [random_number, commitment]
    return verifier(transcript, kzg, vk, online, proof)
