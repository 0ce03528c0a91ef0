"""Finding a cell's pieces by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file
``BENCHMARK.json`` gives, and a traffic mix, read from
``bench/traffic/<traffic>.json``; the limits of its ``correct`` numbers
are in ``bench/limits/<cell>.json``, and each per-layer metric is read
by ``bench/metrics/<metric>.py``.  A later cell or metric is a new file
and a new entry: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def resolve(name: str, bench: dict = None, root: Path = ROOT) -> dict:
    """Everything the harness needs of cell ``name``."""
    bench = load(root) if bench is None else bench
    work = _named(bench["workloads"], name, "workload")
    entry = _named(bench["configs"], work["config"], "configuration")
    end_to_end = [m for m in bench["end_to_end"]
                  if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    return {
        "name": name,
        "chips": work["chips"],
        "config": _json(root / entry["file"]),
        "traffic": _json(BENCH / "traffic" / f"{work['traffic']}.json"),
        "limits": _json(BENCH / "limits" / f"{name}.json"),
        "end_to_end": end_to_end,
        "per_layer": [m for m in bench["per_layer"]
                      if _applies(m, name, reported)],
    }


def metric_module(name: str):
    """The reader module ``bench/metrics/<name>.py`` (its ``read(ctx)``
    gives the metric's value, or None where it finds nothing to read)."""
    path = BENCH / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def layer_dims(config: dict) -> list:
    """(d_in, heads, head_dim) of each layer: hidden layers at the
    configuration's width, the last one out to the classes (one head)."""
    num_layers, hidden = config["num_layers"], config["hidden_dim"]
    out = []
    for ell in range(num_layers):
        d_in = config["graph"]["feature_dim"] if ell == 0 else hidden
        last = ell == num_layers - 1
        d_out = config["graph"]["num_classes"] if last else hidden
        heads = config["heads"] if config["model"] == "gat" and not last \
            else 1
        out.append((d_in, heads, d_out // heads))
    return out
