"""No module the benchmark runs is JAX, jaxlib, flax or the JAX package
(whole top-level names), and the plain references import nothing of the
port.  Each check runs in a fresh process."""

import ast
import glob
import os
import subprocess
import sys

from portbench import harness

PORT = "orb_slam3_study_kr_tpu_torch"


def _fresh(code):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_forbidden_names_are_compared_whole():
    names = [PORT, PORT + ".ops", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(names) == []
    assert harness.forbidden_modules(["orb_slam3_study_kr_tpu.ops", "jax",
                                      "jaxlib.xla_client"]) == [
        "jax", "jaxlib.xla_client", "orb_slam3_study_kr_tpu.ops"]


def test_a_run_on_the_cpu_loads_no_jax():
    code = """
import argparse, time, sys
from portbench import harness, run
tr = harness.load_traffic("gba")
tr["map"].update(keyframes=32, obs_per_kf=64)
harness.load_traffic = lambda name: tr
a = argparse.Namespace(workload="euroc_stereo-gba", seed=2**33 + 1,
                       seconds=0.2, trace=0, control=0)
res, checks = run.run_cell(a, device="cpu", t_start=time.perf_counter())
for m in harness.load_benchmark()["per_layer"]:
    harness.load_module(harness.data_path("metrics", m["name"] + ".py"), "x")
import portbench.kinds.session, portbench.trace, portbench.render
assert "orb_slam3_study_kr_tpu_torch" in sys.modules
print(res["correct"], harness.forbidden_modules())
"""
    assert _fresh(code) == "True []"


def test_references_import_nothing_of_the_port():
    code = f"""
import sys, glob, os, importlib
for p in sorted(glob.glob("portbench/reference/*.py")):
    importlib.import_module("portbench.reference." + os.path.basename(p)[:-3])
print(sorted(n for n in sys.modules if n.split(".")[0] in
             ("{PORT}", "jax", "jaxlib", "flax", "orb_slam3_study_kr_tpu")))
"""
    assert _fresh(code) == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_name_no_forbidden_module():
    files = glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        assert set(_imports(path)) <= {"numpy", "torch", "portbench"}, path
