"""The port's Anemoi hash, its traces and its circuit gadgets against the JAX
package, exactly.

  * the constants, the permutation, the variable-length hash and the stream
    cipher (with their traces: the states before and after each permutation
    and the per-round intermediate values) are equal for seeded inputs;
  * the VLH and stream-cipher gadget circuits, built by each package's own
    TurboCS with its own `load_anemoi_parameters`, have equal wiring,
    selectors, Anemoi selectors (`q_prk`, nonzero) and witness, and pass
    the port's `verify_witness`, which also refuses a broken witness.
"""

import random
from dataclasses import asdict

import pytest

from uzkge_tpu.constants import anemoi_constants as jconst
from uzkge_tpu.hash import anemoi as janemoi
from uzkge_tpu_torch.constants import anemoi_constants as tconst
from uzkge_tpu_torch.constants.bn254 import R_MOD
from uzkge_tpu_torch.hash import anemoi as tanemoi


def _inputs(seed: int, k: int):
    rng = random.Random(seed)
    return [rng.randrange(R_MOD) for _ in range(k)]


def test_constants_match_jax():
    names = [n for n in dir(jconst) if n.isupper()]
    assert names == [n for n in dir(tconst) if n.isupper()]
    for n in names:
        assert getattr(tconst, n) == getattr(jconst, n), n
    assert tanemoi.sanity_check_preprocessed_keys() and janemoi.sanity_check_preprocessed_keys()


def test_permutation_matches_jax():
    for seed in range(4):
        v = _inputs(seed, 4)
        x, y = v[:2], v[2:]
        assert tanemoi.anemoi_permutation(list(x), list(y)) == \
            janemoi.anemoi_permutation(list(x), list(y))
        assert tanemoi._permutation_with_rounds(list(x), list(y)) == \
            janemoi._permutation_with_rounds(list(x), list(y))


@pytest.mark.parametrize("k", [0, 1, 2, 3, 4, 7])
def test_variable_length_hash_matches_jax(k):
    v = _inputs(10 + k, k)
    assert tanemoi.eval_variable_length_hash(v) == janemoi.eval_variable_length_hash(v)
    t, j = tanemoi.eval_variable_length_hash_with_trace(v), \
        janemoi.eval_variable_length_hash_with_trace(v)
    assert asdict(t) == asdict(j) and t.output == tanemoi.eval_variable_length_hash(v)


@pytest.mark.parametrize("k,out_len", [(1, 1), (2, 3), (3, 4), (4, 7), (2, 49)])
def test_stream_cipher_matches_jax(k, out_len):
    v = _inputs(20 + k, k)
    t, j = tanemoi.eval_stream_cipher_with_trace(v, out_len), \
        janemoi.eval_stream_cipher_with_trace(v, out_len)
    assert asdict(t) == asdict(j) and len(t.output) == out_len
    assert tanemoi.eval_stream_cipher(v, out_len) == janemoi.eval_stream_cipher(v, out_len)


def _vlh_circuit(TurboCS, anemoi, v):
    trace = anemoi.eval_variable_length_hash_with_trace(v)
    cs = TurboCS()
    cs.load_anemoi_parameters()
    ivars = [cs.new_variable(x) for x in v]
    cs.anemoi_variable_length_hash(trace, ivars, cs.new_variable(trace.output))
    return cs


def _cipher_circuit(TurboCS, anemoi, v, out_len):
    trace = anemoi.eval_stream_cipher_with_trace(v, out_len)
    cs = TurboCS()
    cs.load_anemoi_parameters()
    ivars = [cs.new_variable(x) for x in v]
    ovars = [cs.new_variable(o) for o in trace.output]
    cs.anemoi_stream_cipher(trace, ivars, ovars)
    return cs


def _assert_same_circuit(tcs, jcs):
    assert tcs.size == jcs.size and tcs.num_vars == jcs.num_vars
    assert tcs.wiring == jcs.wiring and tcs.selectors == jcs.selectors
    assert tcs.anemoi_constraints_indices == jcs.anemoi_constraints_indices
    assert tcs.boolean_constraint_indices == jcs.boolean_constraint_indices
    assert (tcs.anemoi_prk_x, tcs.anemoi_prk_y) == (jcs.anemoi_prk_x, jcs.anemoi_prk_y)
    assert (tcs.anemoi_generator, tcs.anemoi_generator_inv) == \
        (jcs.anemoi_generator, jcs.anemoi_generator_inv)
    prk = tcs.compute_anemoi_jive_selectors()
    assert prk == jcs.compute_anemoi_jive_selectors()
    assert any(any(row) for row in prk)
    tw, jw = tcs.get_and_clear_witness(), jcs.get_and_clear_witness()
    assert tw == jw
    tcs.verify_witness(tw, [])
    return tw


@pytest.mark.parametrize("k", [1, 4])
def test_vlh_gadget_matches_jax(k):
    import uzkge_tpu.plonk.gadgets  # noqa: F401  (attaches gadget methods)
    import uzkge_tpu_torch.plonk.gadgets  # noqa: F401
    from uzkge_tpu.plonk.cs import TurboCS as JaxTurboCS
    from uzkge_tpu_torch.plonk.cs import TurboCS

    v = _inputs(30 + k, k)
    tcs = _vlh_circuit(TurboCS, tanemoi, v)
    jcs = _vlh_circuit(JaxTurboCS, janemoi, v)
    w = _assert_same_circuit(tcs, jcs)
    w[tcs.wiring[0][tcs.anemoi_constraints_indices[0] + 1]] += 1  # a round's state
    with pytest.raises(AssertionError, match="anemoi"):
        tcs.verify_witness(w, [])


@pytest.mark.parametrize("k,out_len", [(2, 1), (2, 4), (3, 7)])
def test_stream_cipher_gadget_matches_jax(k, out_len):
    import uzkge_tpu.plonk.gadgets  # noqa: F401
    import uzkge_tpu_torch.plonk.gadgets  # noqa: F401
    from uzkge_tpu.plonk.cs import TurboCS as JaxTurboCS
    from uzkge_tpu_torch.plonk.cs import TurboCS

    v = _inputs(40 + k, k)
    _assert_same_circuit(_cipher_circuit(TurboCS, tanemoi, v, out_len),
                         _cipher_circuit(JaxTurboCS, janemoi, v, out_len))


def test_cs_helpers_match_jax():
    """add_variables, sub, is_equal(_or_not_equal), get_hiding_degree and
    eval_gate_func: equal rows and witness, and `verify_witness` passes."""
    from uzkge_tpu.plonk.cs import TurboCS as JaxTurboCS
    from uzkge_tpu_torch.plonk.cs import TurboCS

    def build(cls):
        cs = cls()
        a, b = cs.new_variable(5), cs.new_variable(9)
        cs.add_variables([7, R_MOD + 7])
        c = cs.num_vars - 1
        d = cs.sub(b, a)
        eq, neq = cs.is_equal_or_not_equal(a, b)
        same = cs.is_equal(c, c - 1)
        cs.prepare_pi_variable(d)
        cs.pad()
        return cs, [eq, neq, same, d]

    (tcs, tv), (jcs, jv) = build(TurboCS), build(JaxTurboCS)
    assert tv == jv and tcs.wiring == jcs.wiring and tcs.selectors == jcs.selectors
    w = tcs.get_and_clear_witness()
    assert w == jcs.get_and_clear_witness()
    assert [w[v] for v in tv] == [0, 1, 1, 4]
    assert [tcs.get_hiding_degree(i) for i in range(5)] == \
        [jcs.get_hiding_degree(i) for i in range(5)] == [3, 3, 3, 2, 2]
    tcs.verify_witness(w, [4])
    with pytest.raises(AssertionError, match="PI mismatch"):
        tcs.verify_witness(w, [5])
    sels = [1, 2, 3, 4, 5, 6, 7, 8, 9]
    wires = [11, 12, 13, 14, 15]
    assert TurboCS.eval_gate_func(wires, sels, 3) == JaxTurboCS.eval_gate_func(wires, sels, 3)
