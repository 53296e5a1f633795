"""The torch port runs without JAX.

The card's machine has no JAX, so neither uzkge_tpu_torch nor chip_smoke.py
may import it, even through a `uzkge_tpu` module.  A subprocess with
sys.modules['jax'] = None (any `import jax` then raises) imports every
module of the port and builds and verifies a tiny proof.
"""

import ast
import os
import pkgutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "uzkge_tpu_torch")

_SCRIPT = r"""
import importlib, pkgutil, random, sys
sys.modules["jax"] = None
import torch
torch.set_num_threads(1)
import uzkge_tpu_torch
for m in pkgutil.walk_packages(uzkge_tpu_torch.__path__, "uzkge_tpu_torch."):
    importlib.import_module(m.name)

from uzkge_tpu.plonk.cs import TurboCS
import uzkge_tpu.plonk.gadgets
from uzkge_tpu.utils.transcript import Transcript
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
kzg = KZG.setup_insecure(2 * cs.size + 10, tau=1234567)
pp = indexer(cs, kzg, with_shuffle=False)
proof = prover(random.Random(1), Transcript(b"T"), kzg, cs, pp, w)
online = [w[i] for i in cs.public_vars_witness_indices]
assert verifier(Transcript(b"T"), kzg, pp.verifier_params, online, proof)
jaxy = sorted(k for k, v in sys.modules.items()
              if v is not None and (k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")))
assert not jaxy, jaxy
print("NOJAX-OK")
"""


def test_port_imports_and_proves_without_jax():
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


# uzkge_tpu modules the port may import: the JAX-free host side
_HOST_OK = ("uzkge_tpu.constants", "uzkge_tpu.curve", "uzkge_tpu.hash", "uzkge_tpu.crypto",
            "uzkge_tpu.errors", "uzkge_tpu.ff.field", "uzkge_tpu.plonk.cs",
            "uzkge_tpu.plonk.gadgets", "uzkge_tpu.plonk.helpers", "uzkge_tpu.plonk.proof_io",
            "uzkge_tpu.utils.transcript", "uzkge_tpu.utils.serialize", "uzkge_tpu.utils.chacha",
            "uzkge_tpu.native_host", "uzkge_tpu.pcs.pairing", "uzkge_tpu.shuffle.primitives")


def test_port_sources_import_only_host_modules():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PORT):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            assert mod != "jax" and not mod.startswith("jax."), (path, mod)
            if mod.startswith("uzkge_tpu.") or mod == "uzkge_tpu":
                assert mod.startswith(_HOST_OK), (path, mod)
    assert {m.name for m in pkgutil.iter_modules([PORT])} >= {"ff", "ntt", "msm", "pcs", "plonk",
                                                               "shuffle", "utils", "gen_params"}
