"""Proof-level data parallelism: many independent shuffle proofs at once.

Counterpart of `uzkge_tpu/parallel/batch.py`.  The proof axis is
embarrassingly parallel, so proof i runs on devices[i % len(devices)], one
worker thread per entry of `devices`: while one thread's proof waits on its
device, the others drive their host phases (the native-C polynomial
arithmetic and the kernels' launches release the GIL; the pure-Python
curve and transcript code does not).  Two entries naming one card give two
threads on it: their kernels share the card's stream and run one after
another, their host phases overlap.

Unlike the JAX package, which shares one KZG across its devices, each device
here proves on its own (pp, kzg) pair: a KZG holds its device, its
fixed-base table and its MSM bases (pcs/kzg.py).  `replicate` makes a pair
on another device: the proving key's tensors copied there, and a KZG over
the same host points and commit route, which builds its own table on its
first commit.  The pairs live on `pp`, one per device, made once under a
lock; for the device `kzg` is on, the pair is (pp, kzg) themselves.

What is per thread and what is shared in a threaded batch: a span
(utils/stagetimer.py) nests only under the spans of its own thread, and
`recording()` tags each span with its thread; `kernels.LAUNCHES` and
`kernels.CALLS` count every launch of every thread, under a lock.  But
`stagetimer.snapshot()` sums the seconds of all threads' spans of a name,
the counters do not say which thread launched, and `stage(block=...)` still
waits for the whole device, so a span in one thread also waits for the
other threads' kernels.
"""

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import fields, replace as dc_replace
from typing import List, Optional

import torch

from ..device import resolve
from ..pcs.kzg import KZG


def replicate(pp, kzg, device):
    """A fresh (pp, kzg) pair on `device`: every tensor of `pp` copied there
    (always a copy, also onto the device it is on), and a KZG over kzg's host
    points with its `fixed_base` route, whose table or MSM bases are built on
    its first commit.  A KZG on a process group is refused: its collectives
    belong to its process."""
    if kzg.group is not None:
        raise ValueError("a KZG on a process group cannot be replicated: its collectives "
                         "belong to its process")
    dev = resolve(device)
    copies = {}
    for f in fields(pp):
        val = getattr(pp, f.name)
        if isinstance(val, torch.Tensor):
            copies[f.name] = val.to(dev, copy=True)
    pp_dev = dc_replace(pp, **copies)
    kzg_dev = KZG(kzg.g1_powers, kzg.g2_powers, device=dev, fixed_base=kzg.fixed_base)
    if kzg.lagrange_n:
        kzg_dev.set_lagrange(kzg._lagrange_points)
    return pp_dev, kzg_dev


# The replicas live on the params object, as in the JAX package (a module
# dict keyed by id(pp) could serve a stale key once ids are reused, and would
# pin every replica's device memory); refresh_prover_params_public_key drops
# them with the key they copied.
_PP_LOCK = threading.Lock()


def _pp_for_device(pp, kzg, device):
    """(pp, kzg) for kzg's own device, else the replica on `device`, made on
    the first call and cached on pp."""
    dev = resolve(device)
    if dev == kzg.device:
        return pp, kzg
    with _PP_LOCK:
        cache = getattr(pp, "_device_replicas", None)
        if cache is None:
            cache = {}
            object.__setattr__(pp, "_device_replicas", cache)
        got = cache.get(str(dev))
        if got is None:
            got = replicate(pp, kzg, dev)
            cache[str(dev)] = got
    return got


def _devices(devices) -> List[torch.device]:
    """The listed devices, or every visible card; raises without one."""
    if devices is None:
        resolve()  # raises where there is no card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [resolve(d) for d in devices]


def prove_shuffle_batch(rngs: List, aggregate_public_key, decks: List[List], pp, kzg,
                        devices: Optional[List] = None):
    """Prove many shuffles concurrently, proof i on devices[i % len(devices)]
    with one worker thread per entry of `devices` (default: every visible
    card).  With one device or one deck the proofs run in the caller's
    thread, in order.  rngs: one RNG per proof; decks: the input-card lists.
    Returns [(proof, outputs), ...] in input order; each proof equals the
    one prove_shuffle makes alone from the same rng and deck."""
    from ..shuffle import app

    devs = _devices(devices)
    ndev = len(devs)
    if not ndev:
        raise ValueError("prove_shuffle_batch: no device listed")

    def one(i):
        dev = devs[i % ndev]
        pp_dev, kzg_dev = _pp_for_device(pp, kzg, dev)
        ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with ctx:  # the CUDA current device is per thread
            return app.prove_shuffle(rngs[i], aggregate_public_key, decks[i], pp_dev, kzg_dev)

    if ndev == 1 or len(decks) == 1:
        return [one(i) for i in range(len(decks))]
    if kzg.group is not None:
        raise ValueError("a KZG on a process group proves in its process's thread only")
    with ThreadPoolExecutor(max_workers=ndev) as ex:
        return list(ex.map(one, range(len(decks))))
