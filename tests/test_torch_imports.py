"""The torch port stands alone: no JAX, and nothing of the JAX package.

The card's machine has no JAX, and the port keeps its own copies of the host
modules it needs, so neither uzkge_tpu_torch nor chip_smoke.py may import
`jax` or any `uzkge_tpu` module (the parameter binaries under
uzkge_tpu/parameters/ are read by path, as data).  A subprocess with
sys.modules['jax'] = sys.modules['uzkge_tpu'] = None (any import of either
then raises) imports every module of the port and builds and verifies a tiny
proof with the port's own TurboCS, gadgets and Transcript.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "uzkge_tpu_torch")

_SCRIPT = r"""
import importlib, pkgutil, random, sys
sys.modules["jax"] = None
sys.modules["uzkge_tpu"] = None
import torch
torch.set_num_threads(1)
import uzkge_tpu_torch
for m in pkgutil.walk_packages(uzkge_tpu_torch.__path__, "uzkge_tpu_torch."):
    importlib.import_module(m.name)

from uzkge_tpu_torch.plonk.cs import TurboCS
import uzkge_tpu_torch.plonk.gadgets
from uzkge_tpu_torch.utils.transcript import Transcript
from uzkge_tpu_torch.pcs.kzg import KZG
from uzkge_tpu_torch.plonk.indexer import indexer
from uzkge_tpu_torch.plonk.prover import prover
from uzkge_tpu_torch.plonk.verifier import verifier

cs = TurboCS()
a, b, c = cs.new_variable(2), cs.new_variable(5), cs.new_variable(7)
cs.insert_add_gate(a, b, c)
cs.prepare_pi_variable(c)
cs.pad(min_size=8)
w = cs.get_and_clear_witness()
kzg = KZG.setup_insecure(2 * cs.size + 10, tau=1234567, device="cpu")
pp = indexer(cs, kzg, with_shuffle=False)
proof = prover(random.Random(1), Transcript(b"T"), kzg, cs, pp, w)
online = [w[i] for i in cs.public_vars_witness_indices]
assert verifier(Transcript(b"T"), kzg, pp.verifier_params, online, proof)
foreign = sorted(k for k, v in sys.modules.items() if v is not None and
                 k.split(".")[0] in ("jax", "jaxlib", "uzkge_tpu"))
assert not foreign, foreign
print("NOJAX-OK")
"""


def test_port_imports_and_proves_without_jax_or_the_jax_package():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NOJAX-OK" in res.stdout


def _imported_modules(path):
    """Absolute imports of a file; `from pkg import x` yields pkg.x."""
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                yield f"{node.module}.{a.name}"


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 30
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "uzkge_tpu"), (path, mod)
    assert {m.name for m in pkgutil.iter_modules([PORT])} >= {
        "constants", "curve", "ff", "hash", "msm", "ntt", "parallel", "pcs", "plonk", "shuffle",
        "utils", "errors", "native_host", "gen_params", "device", "kernels"}


def test_entry_points_default_to_the_card(monkeypatch):
    """With no card, every public entry point given no device raises rather
    than fall back to the CPU; given device="cpu" it runs there."""
    import torch

    from uzkge_tpu_torch.curve.bn254 import G1_GEN
    from uzkge_tpu_torch.device import resolve
    from uzkge_tpu_torch.ff.field import fq, fr, from_jax_limbs
    from uzkge_tpu_torch.gen_params import load_srs
    from uzkge_tpu_torch.msm.fixed_base import FixedBaseTable
    from uzkge_tpu_torch.msm.msm import MSMBases
    from uzkge_tpu_torch.ntt.ntt import NTTDomain, get_domain
    from uzkge_tpu_torch.pcs.kzg import KZG
    from uzkge_tpu_torch.shuffle.app import gen_shuffle_prover_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = [G1_GEN] * 4
    for call in (lambda: resolve(), lambda: resolve("cuda"), lambda: NTTDomain(8),
                 lambda: get_domain(8), lambda: MSMBases(pts), lambda: KZG(pts, []),
                 lambda: load_srs(4096), lambda: FixedBaseTable(pts, c=4, bits=30),
                 lambda: fr.to_mont_limbs([1]), lambda: fq.const(1),
                 lambda: from_jax_limbs([[0] * 16]), lambda: gen_shuffle_prover_params(1)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()
    assert resolve("cpu") == torch.device("cpu")
    assert MSMBases(pts, "cpu").x.device.type == "cpu"
