"""BENCHMARK.json against the contract, and every name in it found by name."""

import json
import os
import re
import shutil

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def doc():
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_names():
    d = doc()
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["perfbench"] and 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in d[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in d["end_to_end"]} >= {"setup_s"}
    for w in d["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_every_cell_reports_enough():
    d = doc()
    applies = lambda m, w: w in m.get("workloads", [w])
    for w in (x["name"] for x in d["workloads"]):
        e2e = [m["name"] for m in d["end_to_end"] if applies(m, w)]
        assert "setup_s" in e2e and len(e2e) >= 2
        per = [m for m in d["per_layer"] if applies(m, w)]
        assert per
        for m in per:  # the metric's cells report the end-to-end metric it moves
            assert m["moves"] in e2e


@pytest.mark.parametrize("cell", [w["name"] for w in doc()["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.Spec().cell(cell)
    assert c.config["latent_dim"] > 0 and c.traffic["driver"]
    harness.driver(c.traffic["driver"])
    for m in c.end_to_end + c.per_layer:
        assert callable(harness.reader(m["name"]))
    assert set(c.limits) and all(v > 0 for v in c.limits.values())


def test_new_cell_needs_only_new_files(tmp_path):
    """A configuration, a mix, a metric and a cell added as new files and
    entries: every file that was there stays as it was."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (root / "perfbench").rglob("*") if p.is_file()}
    d = doc()
    base = d["workloads"][0]
    (root / "perfbench/configs/NEW.json").write_text(
        (root / "perfbench" / "configs" / (base["config"] + ".json")).read_text())
    (root / "perfbench/traffic/new_mix.json").write_text(json.dumps(
        dict(harness.Spec().cell(base["name"]).traffic, batch=4)))
    (root / "perfbench/limits/new.cell.json").write_text(json.dumps(
        {"limits": {"rgb_rel_l2": 0.1}}))
    (root / "perfbench/metrics/new.metric.py").write_text("def read(rec):\n    return 42.0\n")
    d["configs"].append(dict(d["configs"][0], name="NEW", file="perfbench/configs/NEW.json"))
    d["workloads"].append(dict(base, name="new.cell", config="NEW", traffic="new_mix"))
    d["per_layer"].append(dict(d["per_layer"][0], name="new.metric", workloads=["new.cell"]))
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    cell = harness.Spec(str(root)).cell("new.cell")
    assert cell.traffic["batch"] == 4 and cell.config_name == "NEW"
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    assert harness.reader("new.metric", str(root))(None) == 42.0
    assert all(p.read_bytes() == b for p, b in before.items())
