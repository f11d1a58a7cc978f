"""Every cell of BENCHMARK.json resolves to its files by name, and the
file keeps to the benchmark's contract."""
import json
import re

import pytest

from perfbench import harness, readers

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_resolve(cell):
    files = harness.cell_files(SPEC, cell)
    assert files["config"]["name"] == files["cell"]["config"]
    assert (harness.ROOT / files["traffic"]["cameras"]).exists()
    assert files["limits"] and all(v > 0 for v in files["limits"].values())
    for m in files["metrics"]:
        assert callable(readers.reader(m["name"]))
    assert files["traffic"]["phase"] in (0, 1, 2)


def test_end_to_end_metrics_are_the_harness_s():
    """The harness reports these two in every cell (a traffic of another
    kind than training needs a runner of its own in the harness)."""
    assert {m["name"] for m in SPEC["end_to_end"]} == {
        "train_steps_per_s", "setup_s"}
    assert not any("workloads" in m for m in SPEC["end_to_end"])


def test_contract_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert all(m["moves"] in e2e for m in SPEC["per_layer"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in SPEC["end_to_end"])
    for c in SPEC["configs"]:
        assert (harness.ROOT / c["file"]).exists()
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_per_layer_workloads_exist():
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
