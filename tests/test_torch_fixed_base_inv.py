"""The torch port's batch inversion against the JAX package's query-level
inversion, exactly.

fq_batch_inv (uzkge_tpu_torch/msm/fixed_base.py), which every level of the
port's fixed-base query uses, against uzkge_tpu/msm/fixed_base.py::
pbatch_inv_fq_fast, which the JAX package's query uses for levels of more
than 4096 pairs: its real kernel bodies (_prefix_kernel,
_fermat_bits_kernel, _invback_kernel) run by the eager grid interpreter of
tests/test_torch_fixed_base_query.py.  Inverses are unique, so the outputs
must be equal limb for limb.  A file of its own: the interpreted Fermat
kernel over 4096 roots alone takes about 90 s of one worker.
"""

import numpy as np
import torch

from uzkge_tpu_torch.constants.bn254 import Q_MOD
from uzkge_tpu_torch.ff import field as tf
from uzkge_tpu_torch.msm import fixed_base as fb

from .test_torch_fixed_base_query import _fq_vals, _port, mini_pallas  # noqa: F401

torch.set_num_threads(1)


def test_pbatch_inv_fq_fast_matches_fq_batch_inv(mini_pallas):  # noqa: F811
    """fq_batch_inv against pbatch_inv_fq_fast at N = 32768 (one level of the
    static-unrolled prefix kernel, the Fermat bit-plane kernel over 4096
    roots, the backward kernel), p - 1 and 1 among the values."""
    from uzkge_tpu.msm.fixed_base import pbatch_inv_fq_fast

    N = 32768
    vals = [v or 1 for v in _fq_vals(np.random.default_rng(5), N)]
    vals[:2] = [Q_MOD - 1, 1]
    a = tf.fq.to_mont_limbs(vals, "cpu")
    want = pbatch_inv_fq_fast(np.moveaxis(tf.to_jax_limbs(a), -1, 0))
    assert [n for n, _, _ in mini_pallas] == ["_prefix_kernel", "_fermat_bits_kernel",
                                               "_invback_kernel"]
    assert torch.equal(fb.fq_batch_inv(a), _port(want))


