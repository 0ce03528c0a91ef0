"""The harness finds every cell, configuration, traffic mix, limit and
per-layer metric of ``BENCHMARK.json`` by its name, and the file keeps
to the contract's shapes."""
import json
import re

import pytest

from bench import compare, graphgen, spec

BENCH = spec.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.resolve(name)
    assert cell["chips"] == 1
    assert set(cell["limits"]) <= set(compare.NUMBERS)
    assert {"loss_gap", "grad_gap", "step_gap"} <= set(cell["limits"])
    assert cell["traffic"]["sync_interval"] >= 1
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        mod = spec.metric_module(m["name"])
        assert callable(mod.read)
        # A reader that finds nothing to read returns nothing.
        assert mod.read({"config": cell["config"],
                         "traffic": cell["traffic"]}) is None
    # Every key that reduced names is in the configuration's file, and
    # the generator takes the graph block as it stands.
    entry = next(c for c in BENCH["configs"]
                 if c["name"] == [w for w in BENCH["workloads"]
                                  if w["name"] == name][0]["config"])
    assert all(k in cell["config"] for k in entry["reduced"])
    small = {**cell["config"], "num_nodes": 300}
    g = graphgen.generate(small, 5)
    assert g["features"].shape == (300, cell["config"]["graph"]
                                   ["feature_dim"])


def test_every_metric_applies_to_some_cell():
    used = {m["name"] for c in CELLS for m in spec.resolve(c)["per_layer"]}
    assert used == {m["name"] for m in BENCH["per_layer"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.resolve("no-such-cell")
