"""Parameter loading: the SRS and the embedded verifier keys.

Counterpart of `uzkge_tpu/gen_params.py` (reference gen_params/mod.rs and
shuffle/src/gen_params).  It reads the same embedded binaries, the
reference's published artifacts in `uzkge_tpu/parameters/`: data files,
read by path, with nothing of that package imported.
"""

import os
from functools import lru_cache

from .device import resolve
from .errors import MissingSRSError, MissingVerifierParamsError
from .utils import serialize as ser

from .pcs.kzg import KZG
from .plonk.indexer import VerifierParams

PARAMS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "uzkge_tpu", "parameters")


def _read_required(name: str, err_cls) -> bytes:
    path = os.path.join(PARAMS_DIR, name)
    if not os.path.exists(path):
        raise err_cls(f"embedded parameter file {name} not found")
    with open(path, "rb") as f:
        return f.read()


_SRS_CACHE: dict = {}


def load_srs(size: int, device=None, fixed_base=None, group=None) -> KZG:
    """Padded SRS plus the Lagrange bases for circuit size n
    (gen_params/mod.rs:144-183), cached per (size, device, fixed_base,
    group): the commit route (KZG's `fixed_base` and `group`) is part of the
    key, so that KZGs on two routes over one SRS do not share their bases or
    table."""
    dev = resolve(device)
    key = (size, str(dev), fixed_base, group)
    kzg = _SRS_CACHE.get(key)
    if kzg is not None:
        return kzg
    g1, g2 = ser.load_srs_params(size, _read_required("srs-padding.bin", MissingSRSError))
    kzg = KZG(g1, g2, device=dev, fixed_base=fixed_base, group=group)
    lag_name = f"lagrange-srs-{size}.bin"
    if os.path.exists(os.path.join(PARAMS_DIR, lag_name)):
        lg1, _ = ser.load_srs_unchecked(_read_required(lag_name, MissingSRSError))
        kzg.set_lagrange(lg1)
    _SRS_CACHE[key] = kzg
    return kzg


def _vk_from_parsed(parsed: dict, with_shuffle: bool) -> VerifierParams:
    vk = parsed["vk"]
    return VerifierParams(
        cm_q_vec=vk["cm_q_vec"],
        cm_s_vec=vk["cm_s_vec"],
        cm_qb=vk["cm_qb"],
        cm_prk_vec=vk["cm_prk_vec"],
        anemoi_generator=vk["anemoi_generator"],
        anemoi_generator_inv=vk["anemoi_generator_inv"],
        k=vk["k"],
        cs_size=vk["cs_size"],
        public_vars_constraint_indices=vk["public_vars_constraint_indices"],
        lagrange_constants=vk["lagrange_constants"],
        with_shuffle=with_shuffle,
        cm_q_ecc=vk.get("cm_q_ecc"),
        cm_shuffle_generator_vec=vk.get("cm_shuffle_generator_vec", []),
        cm_shuffle_public_key_vec=vk.get("cm_shuffle_public_key_vec", []),
        edwards_a=vk.get("edwards_a", 0),
    )


@lru_cache(maxsize=4)
def _parsed_shuffle_vk(n_cards: int) -> dict:
    return ser.parse_verifier_params_specific(
        _read_required(f"vk-specific-{n_cards}.bin", MissingVerifierParamsError))


def load_shuffle_verifier_params(n_cards: int) -> VerifierParams:
    """Embedded shuffle vk for n_cards in {48, 52, 54}
    (shuffle/src/gen_params/mod.rs:6-31).  A fresh object per call: the
    public-key refresh writes into it."""
    return _vk_from_parsed(_parsed_shuffle_vk(n_cards), with_shuffle=True)
