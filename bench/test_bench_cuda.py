"""A whole run of each cell on the card at a small size: the kernels'
path, the trace's readers and the comparison.  Marked ``cuda``: skipped
where no card is present; on the card

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_cuda.py
"""
import pytest
import torch

from bench import harness, spec

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.parametrize("name", CELLS)
def test_a_small_traced_run_on_the_card(card, name):
    cell = spec.resolve(name)
    cell["config"] = {**cell["config"], "num_nodes": 12000}
    res = harness.run_cell(cell, 2 ** 31 + 11, 1.0, True, card)
    assert res["correct"], res["compared"]
    assert res["memory_peak_bytes"] > 0
    assert 0 < res["busy_s"] <= res["window_s"]
    for m in cell["per_layer"]:
        assert m["name"] in res["metrics"], m["name"]
        if m["unit"] == "%":
            assert 0 < res["metrics"][m["name"]] <= 105
