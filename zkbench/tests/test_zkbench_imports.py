"""No module of the benchmark imports JAX or the JAX package, top-level
names compared whole (`uzkge_tpu_torch` begins with `uzkge_tpu`); the
reference imports nothing of the program either."""

import ast
import glob
import os
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "uzkge_tpu"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in glob.glob(os.path.join(ROOT, "zkbench", sub, "**", "*.py"), recursive=True)
            if "/cache/" not in p]


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        if "/tests/" in path:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference") + _sources("yardstick"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"uzkge_tpu_torch", "torch", "zkbench"}), path


def test_forbidden_names_compare_whole(monkeypatch):
    sys.path.insert(0, ROOT)
    from zkbench import run

    for name in ("uzkge_tpu_torch", "uzkge_tpu_torch.plonk", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    base = set(run.forbidden_modules())
    assert not base & {"uzkge_tpu_torch", "jaxtyping", "flaxen"}
    for name, top in (("uzkge_tpu.plonk", "uzkge_tpu"), ("jaxlib.xla", "jaxlib"), ("jax", "jax"),
                      ("flax", "flax")):
        monkeypatch.setitem(sys.modules, name, object())
        assert top in run.forbidden_modules()


def test_harness_imports_without_jax():
    """The harness, its apps, metrics and reference import in a process
    where JAX and the JAX package cannot be imported."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'uzkge_tpu'): sys.modules[m] = None\n"
            "import importlib, glob, os\n"
            "for p in sorted(glob.glob('zkbench/**/*.py', recursive=True)):\n"
            "    if '/tests/' in p or '/cache/' in p: continue\n"
            "    importlib.import_module(p[:-3].replace(os.sep, '.').replace('.__init__', ''))\n"
            "from zkbench import run\n"
            "import uzkge_tpu_torch.shuffle.app, uzkge_tpu_torch.matchmaking.app\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"
