"""The harness finds a configuration, a cell and a metric by name: files
added to a copy of the checkout are picked up, no existing file edited."""

import json
import os
import subprocess
import sys

from .conftest import ROOT, add_small_lobby_cell, copy_checkout

PROBE = r"""
import json, sys, types
from zkbench import run
bench, cell, config, spec = run.load_cell(sys.argv[1], sys.argv[2])
names = [m["name"] for m in run.cell_metrics(bench, cell, True)]
reader = __import__("zkbench.metrics.stage_probe_s", fromlist=["read"])
r = run.Run(config, None)
r.stages = [{"r4_horner": 0.5}, {"r4_horner": 1.5}]
print(json.dumps({"config": config["name"], "app": config["app"], "spec": spec,
                  "metrics": names, "value": reader.read(r)}))
"""


def test_added_cell_config_and_metric_are_found(tmp_path):
    root = copy_checkout(str(tmp_path))
    before = {os.path.relpath(os.path.join(d, f), root)
              for d, _, fs in os.walk(os.path.join(root, "zkbench")) for f in fs}
    cell = add_small_lobby_cell(root)
    with open(os.path.join(root, "zkbench", "metrics", "stage_probe_s.py"), "w") as f:
        f.write("def read(run):\n    return run.stage_mean(('r4_horner',))\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({"name": "stage_probe_s", "unit": "s", "better": "lower",
                               "source": "program_span", "layer": "prover rounds and commits",
                               "moves": "proof_latency_s", "workloads": [cell]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = {os.path.relpath(os.path.join(d, f), root)
             for d, _, fs in os.walk(os.path.join(root, "zkbench")) for f in fs}
    assert before <= after  # only added files

    out = subprocess.run([sys.executable, "-c", PROBE, root, cell], cwd=root, check=True,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": root})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["config"] == "mm5" and got["app"] == "matchmaking"
    assert got["spec"]["next_input"] == "fresh"
    assert got["metrics"] == ["stage_probe_s"]
    assert got["value"] == 1.0
    # the real cells do not see the new metric
    out = subprocess.run([sys.executable, "-c", PROBE.replace(
        'reader = __import__("zkbench.metrics.stage_probe_s", fromlist=["read"])',
        'reader = types.SimpleNamespace(read=lambda r: None)'), root, "mm50.lobbies"],
        cwd=root, check=True, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": root})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "stage_probe_s" not in got["metrics"] and "build_cs_s" in got["metrics"]


def test_every_cell_of_the_checkout_loads():
    sys.path.insert(0, ROOT)
    from zkbench import run

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        _, cell, config, spec = run.load_cell(ROOT, w["name"])
        assert config["name"] == w["config"] and spec["warmup"] >= 1
        assert {m["name"] for m in run.cell_metrics(bench, cell, False)} == {
            "setup_s", "proof_latency_s", "peak_device_gb"}
