"""Fault injection, the staleness watchdog and resume in the port against
the reference.

The schedule is numpy in both packages, so every decision (``push_ok``,
``down``, ``crashes``, ``drops_push``, ``delays_pull``, ``corrupts_push``),
``wire_crc32`` and ``corrupt_rows`` must equal the reference's exactly.
A faulty training run (flickr-sim at scale 0.15, 2 parts, GCN 3 x 16,
interval 2, watchdog 6, the reference's parameters) must record the
reference's ``push_age`` history exactly and its losses within 1e-4.
Port against port, bit for bit: a zero-rate schedule equals no fault
state, the fault-aware program with an all-true mask equals the plain
one, and a killed and resumed run equals an unbroken one.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import faults as jfaults
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch import checkpoint as tckpt
from repro_torch import optim as toptim
from repro_torch.core import digest as tdigest
from repro_torch.core import faults as tfaults
from repro_torch.core import halo_exchange as thx
from repro_torch.core import predictor as tpred
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

CONFIGS = [dict(seed=3, crash_rate=0.2, drop_push_rate=0.3,
                delay_pull_rate=0.1, corrupt_rate=0.15),
           dict(seed=7, crash_rate=0.15, crash_rounds=2,
                drop_push_rate=0.25, corrupt_rate=0.1),
           dict(seed=1, crash_rate=0.1, crash_rounds=2, drop_push_rate=0.5,
                corrupt_rate=0.1),
           dict(seed=0)]
FAULTY = dict(seed=1, crash_rate=0.1, crash_rounds=2, drop_push_rate=0.5,
              corrupt_rate=0.1)


@functools.lru_cache(maxsize=None)
def _data(parts=2):
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return (g, jdigest.prepare_graph_data(g, parts, seed=0),
            tdigest.prepare_graph_data(g, parts, seed=0, device="cpu"))


def _configs(g):
    base = dict(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1)
    return jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("kw", CONFIGS)
def test_schedule_matches_reference(kw):
    js = jfaults.FaultSchedule(jfaults.FaultConfig(**kw))
    ts = tfaults.FaultSchedule(tfaults.FaultConfig(**kw))
    assert ts.config.enabled == js.config.enabled
    for r in range(1, 51):
        np.testing.assert_array_equal(ts.push_ok(r, 8), js.push_ok(r, 8))
        for w in range(8):
            for name in ("crashes", "drops_push", "delays_pull",
                         "corrupts_push", "down"):
                assert getattr(ts, name)(r, w) == getattr(js, name)(r, w), (
                    name, r, w)


def test_wire_checksum_and_corruption_match_reference():
    rng = np.random.default_rng(4)
    for dtype in (np.float32, np.int8, np.float16):
        rows = (rng.normal(size=(6, 16)) * 20).astype(dtype)
        assert tfaults.wire_crc32(rows) == jfaults.wire_crc32(rows)
        for rnd, worker in ((1, 0), (7, 3), (50, 7)):
            bad = tfaults.corrupt_rows(rows, 5, rnd, worker)
            np.testing.assert_array_equal(
                bad.view(np.uint8), jfaults.corrupt_rows(
                    rows, 5, rnd, worker).view(np.uint8))
            assert tfaults.wire_crc32(bad) != tfaults.wire_crc32(rows)
    empty = np.zeros((0, 4), np.float32)
    assert tfaults.corrupt_rows(empty, 1, 1, 1).size == 0


def test_config_validation_and_normalisation():
    for kw in (dict(crash_rate=1.5), dict(crash_rounds=0),
               dict(retry_backoff=0)):
        with pytest.raises(ValueError):
            tfaults.FaultConfig(**kw)
    assert tfaults.check_schedule(None) is None
    assert tfaults.check_schedule(tfaults.FaultConfig(seed=9)) is None
    sched = tfaults.check_schedule(tfaults.FaultConfig(drop_push_rate=0.1))
    assert isinstance(sched, tfaults.FaultSchedule)
    state = tfaults.attach_fault_state({"store": {"data": torch.zeros(2)}},
                                       3)
    assert state["push_ok"].dtype == torch.bool
    assert state["last_push_round"].dtype == torch.int32
    assert int(tfaults.measured_staleness(
        torch.tensor([3, 5, 1], dtype=torch.int32), 6)) == 5


def _port_run(epochs=6, max_staleness=None, faults=None, predictor=None,
              params=None, precision=None, **kw):
    g, _, tdata = _data()
    _, cfg = _configs(g)
    settings = tdigest.TrainSettings(
        sync_interval=2, max_staleness=max_staleness,
        predictor=predictor or tpred.PredictorConfig(),
        precision=precision or thx.HaloPrecision())
    return tdigest.digest_train(cfg, toptim.adam(5e-3), tdata, settings,
                                epochs, eval_every=1, faults=faults,
                                params=params, **kw)


@pytest.mark.parametrize("pred,storage,ef", [(False, "fp32", False),
                                             (True, "fp32", False),
                                             (True, "int8", True)])
def test_faulty_run_matches_reference(pred, storage, ef):
    """The int8 case carries error feedback: a masked part keeps its
    residual, held to the reference's within 1e-5 (the drift of the
    pushed reps passes into it whole, as in test_torch_train.py) plus,
    where a rep within that drift of a rounding boundary took the other
    int8 code (24 of 11264 values here), one scale step."""
    g, jdata, _ = _data()
    jcfg, _ = _configs(g)
    jp = init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jpc = jpred.PredictorConfig("ema" if pred else "none")
    jset = jdigest.TrainSettings(sync_interval=2, max_staleness=6,
                                 predictor=jpc,
                                 precision=jhx.HaloPrecision(storage, ef))
    jst, jh = jdigest.digest_train(jcfg, joptim.adam(5e-3), jdata, jset, 10,
                                   eval_every=1,
                                   faults=jfaults.FaultConfig(**FAULTY))
    tst, th = _port_run(10, 6, tfaults.FaultConfig(**FAULTY),
                        tpred.PredictorConfig("ema" if pred else "none"),
                        params=tp, precision=thx.HaloPrecision(storage, ef))
    assert th["push_age"] == jh["push_age"]
    assert max(th["push_age"]) < 6
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tst["last_push_round"].numpy(),
                                  np.asarray(jst["last_push_round"]))
    if ef:
        got = tst["push_residual"].numpy()
        want = np.asarray(jst["push_residual"])
        step = float(np.asarray(jst["store"]["scale"]).max())
        diff = np.abs(got - want)
        assert np.all(diff <= 1e-5 + step)
        assert np.mean(diff > 1e-5) < 0.01
    _, clean = _port_run(10, 10 ** 6, params=tp)
    assert max(th["push_age"]) > max(clean["push_age"])
    assert th["loss"] != clean["loss"]
    for leaf in _leaves(tst["params"]):
        assert bool(torch.isfinite(leaf).all())


def test_zero_fault_parity():
    base, base_hist = _port_run()
    off, _ = _port_run(faults=tfaults.FaultConfig(seed=9))
    assert _equal(base, off)
    aware, aware_hist = _port_run(max_staleness=10 ** 6)
    for key in ("params", "store", "cache", "opt_state"):
        assert _equal(base[key], aware[key]), key
    assert base_hist["loss"] == aware_hist["loss"]
    assert max(aware_hist["push_age"]) <= 2


@pytest.mark.parametrize("pred", [False, True])
def test_kill_and_resume_is_bitwise(tmp_path, pred):
    kw = dict(max_staleness=6, faults=tfaults.FaultConfig(
        seed=1, drop_push_rate=0.4, crash_rate=0.1),
        predictor=tpred.PredictorConfig("ema" if pred else "none"),
        ckpt_every=2)
    full, full_hist = _port_run(10, ckpt_dir=str(tmp_path / "a"), **kw)
    _port_run(6, ckpt_dir=str(tmp_path / "b"), **kw)
    resumed, res_hist = _port_run(10, ckpt_dir=str(tmp_path / "b"),
                                  resume=True, **kw)
    assert set(full) == set(resumed)
    assert _equal(full, resumed)
    assert res_hist["loss"] == full_hist["loss"][6:]
    assert res_hist["push_age"] == full_hist["push_age"][6:]
    if pred:
        assert {"pstore", "predictor", "pcache"} <= set(resumed)


def test_resume_falls_back_past_corrupt_newest(tmp_path):
    d = str(tmp_path)
    _port_run(6, ckpt_dir=d, ckpt_every=2)
    assert tckpt.latest_step(d) == 6
    npz = os.path.join(d, "ckpt_00000006.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    assert tckpt.latest_step(d) == 4
    state, hist = _port_run(8, ckpt_dir=d, ckpt_every=2, resume=True)
    assert hist["epoch"] == [5, 6, 7, 8]
    assert np.isfinite(hist["loss"]).all()
    assert state["epoch"] == 8 and isinstance(state["epoch"], int)
    with pytest.raises(ValueError, match="ckpt_dir"):
        _port_run(2, resume=True)
