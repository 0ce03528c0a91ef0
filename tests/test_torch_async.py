"""DIGEST-A in the port against the reference (``repro.core.async_engine``).

At the reference's own size (flickr-sim at scale 0.12, 4 parts, GCN 2 x 32,
``adam(5e-3)``) and from the reference's parameters:

* the reference's four cases (``tests/test_async_engine.py``) on the port:
  the store layout against ``init_state``, the broken-layout error, cold
  pulls with and without the warm start, and the eval ticks' mean loss
  and max delay;
* trajectories: the event order (``round_worker``), ``delay``,
  ``cold_rows``, ``pull_age`` and the fault counters equal to the
  reference's; ``round_loss`` and the F1s within 1e-4, and the final
  parameters within 1e-4 of each leaf's max (the training bar of
  ``tests/test_torch_train.py``), for the plain run, an int8 store with
  error feedback, the SAT predictor, a straggler, and every fault class
  under a tight watchdog;
* ``owner_push`` / ``owner_push_ef`` against the reference on fp32, bf16
  and int8 stores (int8 scales within 1e-6, the rule of the serving
  store's scales), rows outside the owner's shard untouched;
* port against port, bit for bit: ``PredictorConfig("none", ...)`` and
  ``gamma = 0`` against no predictor, a zero-rate schedule under an
  unreachable watchdog against no faults, kill and resume, and resume
  past a corrupt newest checkpoint;
* a checkpoint the reference wrote resumes in the port, whose next
  rounds track the reference's; ``sync_time_per_round`` equals the
  reference's; the ``async_straggler`` launcher runs on the CPU.
"""
import functools
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import optim as joptim
from repro.core import async_engine as jasync
from repro.core import digest as jdigest
from repro.core import faults as jfaults
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch import optim as toptim
from repro_torch.core import async_engine as tasync
from repro_torch.core import digest as tdigest
from repro_torch.core import faults as tfaults
from repro_torch.core import halo_exchange as thx
from repro_torch.core import predictor as tpred
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

TRAJ_TOL = 1e-4
ROUNDS = 24
# Every fault class; with 4 workers a shard's age between cadence pushes
# passes 4 server steps, so the watchdog resyncs too.
FAULTS = dict(seed=1, crash_rate=0.2, drop_push_rate=0.3,
              delay_pull_rate=0.3, corrupt_rate=0.2)


@functools.lru_cache(maxsize=None)
def _graph(seed=0):
    return make_dataset("flickr-sim", scale=0.12, seed=seed)


@functools.lru_cache(maxsize=None)
def _data(num_parts=4, seed=0):
    return (jdigest.prepare_graph_data(_graph(seed), num_parts),
            tdigest.prepare_graph_data(_graph(seed), num_parts,
                                       device="cpu"))


def _configs(num_layers=2, hidden=32):
    g = _graph()
    base = dict(model="gcn", num_layers=num_layers,
                in_dim=g.features.shape[1], hidden_dim=hidden,
                num_classes=int(g.labels.max()) + 1)
    return jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)


@functools.lru_cache(maxsize=None)
def _ref_params(num_layers=2, seed=0):
    jcfg, _ = _configs(num_layers)
    return jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(seed),
                                                jgnn.gnn_specs(jcfg)))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _settings(pkg, storage="fp32", ef=False, predictor=None, faults=None,
              **kw):
    """AsyncSettings of ``pkg`` (the reference's or the port's async
    module), built from the same plain arguments."""
    hx, pred, flt = ((jhx, jpred, jfaults) if pkg is jasync
                     else (thx, tpred, tfaults))
    return pkg.AsyncSettings(
        precision=hx.HaloPrecision(storage, error_feedback=ef),
        predictor=pred.PredictorConfig(*(predictor or ("none",))),
        faults=flt.FaultConfig(**faults) if faults is not None else None,
        **{"sync_interval": 3, "seed": 1, **kw})


def _port_run(rounds=ROUNDS, eval_every=8, ckpt=None, **kw):
    """The port's run from the reference's parameters; ``ckpt`` holds
    digest_a_train's checkpoint arguments, ``kw`` the settings'."""
    _, tcfg = _configs()
    return tasync.digest_a_train(
        tcfg, toptim.adam(5e-3), _data()[1], _settings(tasync, **kw),
        rounds, eval_every_rounds=eval_every,
        params=params_from_numpy(_ref_params(), "cpu"), **(ckpt or {}))


def _ref_run(rounds=ROUNDS, eval_every=8, ckpt=None, **kw):
    jcfg, _ = _configs()
    return jasync.digest_a_train(jcfg, joptim.adam(5e-3), _data()[0],
                                 _settings(jasync, **kw), rounds,
                                 eval_every_rounds=eval_every,
                                 **(ckpt or {}))


def _assert_tracks(jh, th, start=0):
    """The port's history against the reference's: events and integer
    probes equal, losses and F1s within TRAJ_TOL."""
    for key in ("round_worker", "delay", "cold_rows", "pull_age", "round",
                "sim_time"):
        assert th[key] == jh[key], key
    for key in ("round_loss", "loss", "val_f1", "test_f1"):
        np.testing.assert_allclose(th[key][start:], jh[key][start:],
                                   rtol=0, atol=TRAJ_TOL, err_msg=key)


def _assert_params_close(jparams, tparams):
    for a, b in zip(jax.tree.leaves(jparams), _leaves(tparams)):
        a = np.asarray(a)
        err = float(np.abs(b.numpy() - a).max())
        assert err <= TRAJ_TOL * max(float(np.abs(a).max()), 1e-30), err


# ---------------------------------------------------------------------------
# The reference's four cases
# ---------------------------------------------------------------------------

@settings(max_examples=6, deadline=None)
@given(num_parts=st.sampled_from([2, 3, 4, 6]), seed=st.integers(0, 1))
def test_async_store_layout_matches_init_state(num_parts, seed):
    g = _graph(seed)
    jdata, data = _data(num_parts, seed)
    _, cfg = _configs()
    num_slots, shard_rows = tasync.store_geometry(data)
    assert (num_slots, shard_rows) == jasync.store_geometry(jdata)
    assert shard_rows == data["_sp"].shard_rows
    total_rows = int(data["store_ids"].shape[0])
    assert total_rows == num_parts * shard_rows == num_slots + 1
    sentinels = data["sentinel_slots"].numpy()
    assert np.array_equal(sentinels,
                          (np.arange(num_parts) + 1) * shard_rows - 1)
    assert np.all(data["store_ids"].numpy()[sentinels] == g.num_nodes)
    for prec in (thx.HaloPrecision(), thx.HaloPrecision("int8")):
        state = tdigest.init_state(cfg, toptim.adam(1e-3), data,
                                   precision=prec)
        async_store = thx.init_store(cfg.num_layers - 1, num_slots,
                                     cfg.hidden_dim, prec, "cpu")
        assert {k: (v.shape, v.dtype) for k, v in async_store.items()} == \
               {k: (v.shape, v.dtype) for k, v in state["store"].items()}
    slots = data["local_slots"].numpy()
    valid = data["local_valid"].numpy()
    boundary = data["local_boundary"].numpy()
    for m in range(num_parts):
        b = slots[m][boundary[m]]
        assert np.all((b >= m * shard_rows) & (b < sentinels[m])), m
        assert np.all(slots[m][valid[m] & ~boundary[m]] == sentinels[m]), m


def test_store_geometry_rejects_broken_layout():
    jdata, data = (dict(d) for d in _data())
    bad = data["sentinel_slots"].clone()
    bad[0] += 1
    data["sentinel_slots"] = bad
    jdata["sentinel_slots"] = bad.numpy()
    with pytest.raises(ValueError, match="store layout") as got:
        tasync.store_geometry(data)
    with pytest.raises(ValueError) as want:
        jasync.store_geometry(jdata)
    assert str(got.value) == str(want.value)


def test_no_cold_pulls_with_straggler():
    kw = dict(sync_interval=4, straggler=0, seed=3)
    _, hist = _port_run(eval_every=ROUNDS, **kw)
    assert hist["cold_rows"][-1] == 0, hist["cold_rows"]
    # The positive control: without the warm start, fast workers' first
    # pulls read the straggler's never-pushed rows, and the probe counts
    # exactly the reference's.
    _, hist = _port_run(eval_every=ROUNDS, warm_start=False, **kw)
    _, jhist = _ref_run(eval_every=ROUNDS, warm_start=False, **kw)
    assert hist["cold_rows"][-1] > 0
    assert hist["cold_rows"] == jhist["cold_rows"]


def test_history_loss_is_mean_across_workers():
    _, hist = _port_run(rounds=18, eval_every=6, sync_interval=3, seed=1)
    workers, losses = hist["round_worker"], hist["round_loss"]
    assert len(workers) == len(losses) == 18
    for tick, rounds_done in enumerate(hist["round"]):
        last = {}
        for w, l in zip(workers[:rounds_done], losses[:rounds_done]):
            last[w] = l
        want = float(np.mean(list(last.values())))
        assert hist["loss"][tick] == pytest.approx(want, rel=1e-6), tick
    assert len(set(workers[:hist["round"][0]])) > 1


def test_history_delay_is_max_staleness():
    _, hist = _port_run(rounds=60, eval_every=60, sync_interval=3,
                        straggler=0, seed=2)
    assert hist["delay"][-1] >= 8, hist["delay"]


# ---------------------------------------------------------------------------
# Trajectories against the reference
# ---------------------------------------------------------------------------

CASES = {
    "plain": {},
    "int8_ef": dict(storage="int8", ef=True),
    "sat_ema": dict(predictor=("ema", 1.0, 0.5)),
    "straggler": dict(straggler=0, seed=2, rounds=60),
    "faults": dict(faults=FAULTS, max_staleness=4, storage="int8", ef=True,
                   predictor=("ema", 1.0, 0.5)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_trajectory_matches_reference(case):
    kw = CASES[case]
    jst, jh = _ref_run(**kw)
    tst, th = _port_run(**kw)
    _assert_tracks(jh, th)
    assert tst["fault_counters"] == jst["fault_counters"]
    assert tst["pull_age_max"] == jst["pull_age_max"]
    assert tst["step"] == int(jst["step"]) == kw.get("rounds", ROUNDS)
    assert ("pstore" in tst) == ("pstore" in jst)
    _assert_params_close(jst["params"], tst["params"])
    if case == "faults":
        assert all(n > 0 for n in tst["fault_counters"].values()), \
            tst["fault_counters"]
    if case == "straggler":
        assert th["delay"][-1] >= 8


# ---------------------------------------------------------------------------
# owner_push / owner_push_ef
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("owner", [0, 3])
def test_owner_push_matches_reference(storage, owner):
    jdata, data = _data()
    num_slots, shard_rows = tasync.store_geometry(data)
    rng = np.random.default_rng(owner)
    l1, hidden = 2, 16
    rows = rng.normal(size=(l1, num_slots + 1, hidden)).astype(np.float32)
    jprec, tprec = jhx.HaloPrecision(storage), thx.HaloPrecision(storage)
    jq, jsc = jhx.quantize_rows(jax.numpy.asarray(rows), jprec)
    jstore = {"data": jq} if jsc is None else {"data": jq, "scale": jsc}
    before = {k: torch.from_numpy(np.array(v, np.float32))
              .to(tprec.dtype if k == "data" else torch.float32)
              for k, v in jstore.items()}
    slots, valid = data["local_slots"][owner], data["local_valid"][owner]
    reps = rng.normal(size=(l1, slots.shape[0], hidden)).astype(np.float32)
    resid = (rng.normal(size=reps.shape) * 1e-3).astype(np.float32)
    jnew = jhx.owner_push(jstore, owner, jdata["local_slots"][owner],
                          jdata["local_valid"][owner], reps, shard_rows)
    jnew_ef, jres = jhx.owner_push_ef(jstore, owner,
                                      jdata["local_slots"][owner],
                                      jdata["local_valid"][owner], reps,
                                      resid, shard_rows)
    lo, hi = owner * shard_rows, (owner + 1) * shard_rows
    store = {k: v.clone() for k, v in before.items()}
    ptrs = {k: v.data_ptr() for k, v in store.items()}
    new = thx.owner_push(store, owner, slots, valid, torch.from_numpy(reps),
                         shard_rows)
    store_ef = {k: v.clone() for k, v in before.items()}
    new_ef, res = thx.owner_push_ef(store_ef, owner, slots, valid,
                                    torch.from_numpy(reps),
                                    torch.from_numpy(resid), shard_rows)
    assert torch.equal(res, torch.from_numpy(np.array(jres)))
    assert {k: v.data_ptr() for k, v in store.items()} == ptrs
    for got, want, src in ((new, jnew, store), (new_ef, jnew_ef, store_ef)):
        # In place: the store's own tensors, written in the shard alone.
        assert got is src
        gd = got["data"].float()
        assert torch.equal(gd, torch.from_numpy(
            np.array(want["data"], np.float32)))
        for k in got:
            assert torch.equal(got[k][:, :lo], before[k][:, :lo])
            assert torch.equal(got[k][:, hi:], before[k][:, hi:])
        assert float(gd[:, hi - 1].abs().max()) == 0
        if storage == "int8":
            np.testing.assert_allclose(got["scale"].numpy(),
                                       np.asarray(want["scale"]),
                                       rtol=1e-6, atol=0)
            assert float(got["scale"][:, hi - 1].min()) == 1.0


# ---------------------------------------------------------------------------
# Port against port, bit for bit
# ---------------------------------------------------------------------------

def test_inert_predictor_and_zero_rate_faults_are_bitwise():
    base, base_h = _port_run()
    none, none_h = _port_run(predictor=("none", 0.5, 0.3))
    assert _equal(base, none) and base_h == none_h
    g0, g0_h = _port_run(predictor=("ema", 0.0, 0.5))
    assert "pstore" in g0
    assert _equal(base["params"], g0["params"])
    assert base_h["round_loss"] == g0_h["round_loss"]
    assert base_h["round_worker"] == g0_h["round_worker"]
    quiet, quiet_h = _port_run(faults=dict(seed=5), max_staleness=10 ** 6)
    assert _equal(base, quiet) and base_h == quiet_h


def _ckpt_run(d, rounds, resume=False):
    return _port_run(rounds=rounds, faults=FAULTS, max_staleness=4,
                     storage="int8", ef=True, predictor=("ema", 1.0, 0.5),
                     ckpt=dict(ckpt_dir=str(d), ckpt_every_rounds=10,
                               resume=resume))


def test_kill_and_resume_is_bitwise(tmp_path):
    full, full_h = _ckpt_run(tmp_path / "a", 30)
    _ckpt_run(tmp_path / "b", 15)                  # killed at round 15
    resumed, res_h = _ckpt_run(tmp_path / "b", 30, resume=True)
    assert _equal(full, resumed) and full_h == res_h
    assert "pstore" in full and full["fault_counters"]["crashes"] > 0


def test_resume_falls_back_past_corrupt_newest(tmp_path):
    full, full_h = _ckpt_run(tmp_path / "a", 30)
    _ckpt_run(tmp_path / "b", 25)                  # saves rounds 10 and 20
    npz = tmp_path / "b" / "ckpt_00000020.npz"
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    resumed, res_h = _ckpt_run(tmp_path / "b", 30, resume=True)
    assert _equal(full, resumed) and full_h == res_h


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    kw = dict(predictor=("ema", 1.0, 0.5), storage="int8", ef=True,
              straggler=0)
    jst, jh = _ref_run(rounds=20, eval_every=5, **kw)
    # The reference, killed after round 12, checkpointed round 10.
    _ref_run(rounds=12, eval_every=5,
             ckpt=dict(ckpt_dir=str(tmp_path), ckpt_every_rounds=10), **kw)
    _, tcfg = _configs()
    tst, th = tasync.digest_a_train(
        tcfg, toptim.adam(5e-3), _data()[1], _settings(tasync, **kw), 20,
        eval_every_rounds=5, ckpt_dir=str(tmp_path), resume=True)
    _assert_tracks(jh, th, start=10)
    assert th["round_loss"][:10] == jh["round_loss"][:10]   # restored
    assert tst["fault_counters"] == jst["fault_counters"]
    _assert_params_close(jst["params"], tst["params"])


@pytest.mark.parametrize("kw", [dict(), dict(straggler=0, seed=9),
                                dict(worker_speed_jitter=0.5, seed=4,
                                     straggler=0,
                                     straggler_delay=(2.0, 3.0))])
def test_sync_time_per_round_matches_reference(kw):
    for m in (1, 4, 8):
        assert (tasync.sync_time_per_round(tasync.AsyncSettings(**kw), m)
                == jasync.sync_time_per_round(jasync.AsyncSettings(**kw), m))


def test_async_straggler_launcher_on_cpu(capsys):
    from repro_torch.launch import async_straggler
    async_straggler.main(["--device", "cpu", "--rounds", "12"])
    out = capsys.readouterr().out
    assert "sync barrier" in out and "val F1" in out
