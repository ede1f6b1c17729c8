"""Runs of the harness without a card: the command refuses, a cell's
driver imports no JAX, and the plain reference imports nothing of the port."""

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness

FORBIDDEN = ("jax", "jaxlib", "flax", "threedhumangan_tpu")
CELLS = [w["name"] for w in json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))[
    "workloads"]]


def py(code, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, env=env,
                          capture_output=True, text=True, timeout=600, **kw)


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", CELLS[0], "--seed",
                        "2147483999", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


@pytest.mark.parametrize("cell", CELLS)
def test_cell_run_imports_no_jax(cell):
    """The cell's driver, cut to a small size, on the CPU in a process of
    its own: no module of JAX or of the JAX package is loaded."""
    code = f"""
import sys, time, torch
sys.path.insert(0, "perfbench/tests")
from _small import small_cell
from perfbench import harness
cell = small_cell({cell!r})
rec = harness.driver(cell.traffic["driver"]).run(cell, 3, 0.2, False, torch.device("cpu"),
                                                 time.perf_counter())
assert rec.requests and rec.checks
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    p = py(code)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "threedhumangan_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            for node in ast.walk(tree):
                mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                        [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for m in mods:
                    assert m.split(".")[0] not in FORBIDDEN + ("threedhumangan_tpu_torch",), \
                        (name, m)
    p = py("import sys, perfbench.reference.generator, perfbench.reference.smpl, "
           "perfbench.reference.weights, perfbench.reference.discriminator, "
           "perfbench.reference.training; "
           "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert p.returncode == 0, p.stderr
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert not loaded & set(FORBIDDEN + ("threedhumangan_tpu_torch",))
