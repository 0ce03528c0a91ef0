"""A whole run on the CPU at a test size is correct, and ``correct``
comes out false when the timed path is broken underneath
(a run on the CPU, past the harness's look for a card), once for each
fault a training cell can have: a step that returns its state unchanged,
half of the subgraphs left out of the gradient mean, the exchange of
stale representations (the pull) left out.  And the control, the
reference in TF32 in the program's place, fails each cell's limits."""
import pytest
import torch

from bench import compare, control, harness, spec

CELLS = [w["name"] for w in spec.load()["workloads"]]
# A test size: the faults show at any size, and the port's plain CPU
# paths loop over the ELL's width, the features and the subgraphs.
TEST_SIZE = {"num_nodes": 200, "hidden_dim": 16, "num_parts": 2}
TEST_GRAPH = {"avg_degree": 8.0, "num_classes": 8}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cell(name):
    cell = spec.resolve(name)
    config = cell["config"]
    cell["config"] = {**config, **TEST_SIZE,
                      "graph": {**config["graph"], **TEST_GRAPH}}
    return cell


def _plant(monkeypatch, fault):
    from repro_torch.core import digest
    if fault == "unchanged":
        make = digest.make_epoch_fn

        def make_unchanged(*a, **kw):
            epoch_fn = make(*a, **kw)

            def unchanged(state, data):
                return state, epoch_fn(state, data)[1]
            return unchanged
        monkeypatch.setattr(digest, "make_epoch_fn", make_unchanged)
    elif fault == "half_batch":
        mean = digest.mean_grads_of
        monkeypatch.setattr(digest, "mean_grads_of", lambda grads, leaves:
                            mean(grads[:len(grads) // 2], leaves))
    else:
        monkeypatch.setattr(digest, "_digest_pull",
                            lambda cfg, settings, state, *a, **kw:
                            (state["cache"], state.get("pcache")))


@pytest.mark.parametrize("fault", [None, "unchanged", "half_batch",
                                   "no_pull"])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(monkeypatch, name, fault):
    if fault:
        _plant(monkeypatch, fault)
    res = harness.run_cell(_cell(name), 99, 0.0, False, "cpu")
    assert res["correct"] is (fault is None), res["compared"]
    assert set(res["metrics"]) == {"epoch_ms", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = _cell(name)
    nums = control.readings(cell, 7, ["tf32"], "cpu")["tf32"]
    assert not compare.verdict(nums, cell["limits"]), nums
