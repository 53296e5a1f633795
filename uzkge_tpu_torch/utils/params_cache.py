"""On-disk prover-params persistence in the port's own format.

Counterpart of `uzkge_tpu/utils/params_cache.py`, whose pickle holds that
package's objects.  Here nothing is pickled: a cached `ProverParams` is

    <path>.npz   — every tensor as its (..., 8) int32 limbs, through numpy
    <path>.json  — the host part as plain ints, lists and strings, with the
                   verifying key's points as [x, y] pairs (null: identity)
                   and the schema version

`save_pp(path, pp)` writes both; `load_pp(path, cls, device=None)` reads
them back with the tensors on `device` (the card by default) and returns
None on a miss: a missing or unreadable file, or another schema version.
The cache lives under UZKGE_PARAMS_CACHE (default: <repo>/.params-cache),
keyed by content, and is an optimization only: callers fall back to a fresh
build.
"""

import hashlib
import json
import os
import zipfile
from dataclasses import fields

import numpy as np
import torch

from ..device import resolve

# The port's own format; bumped whenever ProverParams' or VerifierParams'
# field layout changes, so that stale files miss by name and by content.
SCHEMA_VERSION = "torch-v1"


def cache_dir() -> str:
    d = os.environ.get(
        "UZKGE_PARAMS_CACHE",
        os.path.join(os.path.dirname(__file__), "..", "..", ".params-cache"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _point_out(v):
    return None if v is None else [int(v[0]), int(v[1])]


def _point_in(v):
    return None if v is None else (v[0], v[1])


def _vk_out(vk) -> dict:
    out = {}
    for f in fields(vk):
        v = getattr(vk, f.name)
        if f.name.startswith("cm_"):
            v = [_point_out(p) for p in v] if isinstance(v, list) else _point_out(v)
        out[f.name] = v
    return out


def _vk_in(cls, d: dict):
    kw = {}
    for name, v in d.items():
        if name.startswith("cm_"):
            v = [_point_in(p) for p in v] if name.endswith("_vec") else _point_in(v)
        kw[name] = v
    return cls(**kw)


def save_pp(path: str, pp) -> None:
    arrays, host = {}, {}
    for f in fields(pp):
        v = getattr(pp, f.name)
        if isinstance(v, torch.Tensor):
            arrays[f.name] = v.detach().cpu().numpy().astype(np.int32)
        elif f.name == "verifier_params":
            host[f.name] = _vk_out(v)
        elif isinstance(v, bytes):
            host[f.name] = {"hex": v.hex()}
        else:
            host[f.name] = v
    np.savez(path, **arrays)
    with open(path + ".json", "w") as fh:
        json.dump({"schema": SCHEMA_VERSION, "pp": host}, fh)


def load_pp(path: str, cls, device=None):
    """The ProverParams saved at `path` as `cls`, with its tensors on
    `device`; None on a miss."""
    if not (os.path.exists(path + ".npz") and os.path.exists(path + ".json")):
        return None
    try:
        with open(path + ".json") as fh:
            rec = json.load(fh)
        if rec.get("schema") != SCHEMA_VERSION:
            return None
        from ..plonk.indexer import VerifierParams

        dev = resolve(device)
        kw = {}
        for name, v in rec["pp"].items():
            if name == "verifier_params":
                v = _vk_in(VerifierParams, v)
            elif isinstance(v, dict):
                v = bytes.fromhex(v["hex"])
            kw[name] = v
        with np.load(path + ".npz") as arrs:
            for name in arrs.files:
                kw[name] = torch.from_numpy(arrs[name]).to(dev)
        return cls(**kw)
    except (OSError, ValueError, KeyError, TypeError, zipfile.BadZipFile):
        return None


def _key(*parts) -> str:
    return hashlib.sha256("".join(parts).encode()).hexdigest()[:16]


def shuffle_pp_cache_path(n_cards: int, apk) -> str:
    # hash the FULL point: apk and -apk share y, and loading the wrong
    # refreshed params would prove against the wrong joint key
    h = _key(f"{apk[0]:064x}{apk[1]:064x}", SCHEMA_VERSION)
    return os.path.join(cache_dir(), f"torch-shuffle-pp-{n_cards}-{h}")


def matchmaking_pp_cache_path(n: int) -> str:
    """Matchmaking params depend only on the player count (the circuit is
    built from `random.Random(0)`, the SRS is embedded)."""
    return os.path.join(cache_dir(), f"torch-matchmaking-pp-{n}-{_key(SCHEMA_VERSION)}")
