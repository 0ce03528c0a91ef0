"""Sampled mini-batch DIGEST training (control variates) in the port
against the reference.

The same flickr-sim graph (scale 0.15, 2 parts), partition and parameters
(the reference's ``init_params`` → numpy → ``params_from_numpy``) go
through the JAX package's jitted ``make_sampled_epoch_fn`` / its
``sampled_train`` (``backend="jnp"``, its gather-form oracles) and the
port's on CPU tensors (its kernels' plain versions), 3 layers of width 16,
``sync_interval=2``.  The sampler is a numpy copy: both packages draw the
same batches, bit for bit.

Tolerances: step-1 per-leaf gradients within 1e-5 of each leaf's max |g|;
the loss, train-F1 and per-layer staleness trajectories within 1e-4
absolute over 6 steps (the full-batch tests' bars, ``test_torch_train``).
Port against port: full coverage (fanout >= max in-degree, every train
row a seed) equals the full-batch epoch bit for bit for gcn/sage and
within 1e-6 for gat; one step from a random history equals one from the
zero history bit for bit at full coverage; kill and resume is bit for
bit; GAT's table gradients through the struct's ``in_pos`` equal those
through a transpose rebuilt from the remapped in-ELL (``torch.equal``).
"""
import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import faults as jfaults
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import build_sampler as jbuild_sampler
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch import checkpoint as tckpt
from repro_torch import optim as toptim
from repro_torch.core import digest as tdigest
from repro_torch.core import faults as tfaults
from repro_torch.core import halo_exchange as thx
from repro_torch.core import predictor as tpred
from repro_torch.graph import build_sampler
from repro_torch.kernels.spmm.spmm import transpose_of
from repro_torch.launch import train_gnn
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

STEPS = 6
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-4
FANOUT = 3
SEEDS = 64


@functools.lru_cache(maxsize=None)
def _data():
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return (g, jdigest.prepare_graph_data(g, 2, seed=0),
            tdigest.prepare_graph_data(g, 2, seed=0, device="cpu"))


def _configs(model, **kw):
    g, _, _ = _data()
    base = dict(model=model, num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1, heads=2)
    base.update(kw)
    return jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)


def _params(jcfg):
    jp = init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(jcfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _capture(module, base):
    """``base`` that also keeps its last update's mean gradient."""
    def init(p):
        return {"opt": base.init(p), "grads": p}

    def update(g, s, p, step):
        new_p, new_s = base.update(g, s["opt"], p, step)
        return new_p, {"opt": new_s, "grads": g}

    return module.Optimizer("capture", init, update)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _settings(module, storage="fp32", predictor="none", **kw):
    pred = (jpred if module is jdigest else tpred).PredictorConfig(predictor)
    hx = jhx if module is jdigest else thx
    return module.TrainSettings(sync_interval=2,
                                precision=hx.HaloPrecision(storage),
                                predictor=pred, **kw)


def _full_coverage(data):
    s = build_sampler(data, fanout=1, batch_seeds=1 << 30, seed=0)
    return build_sampler(data, fanout=max(s.max_in_degree, 1),
                         batch_seeds=1 << 30, seed=0)


# ---------------------------------------------------------------------------
# The sampler
# ---------------------------------------------------------------------------

def test_sampler_batches_equal_reference():
    _, jdata, tdata = _data()
    for fanout, seeds, seed in ((FANOUT, SEEDS, 7), (2, 1 << 30, 0)):
        js = jbuild_sampler(jdata, fanout, seeds, seed=seed)
        ts = build_sampler(tdata, fanout, seeds, seed=seed)
        assert ts.max_in_degree == js.max_in_degree
        for t in (0, 1, 2, 5, 17):
            a, b = js.sample(t), ts.sample(t)
            assert sorted(a) == sorted(b)
            for k in a:
                assert b[k].dtype == a[k].dtype and np.array_equal(b[k],
                                                                   a[k])
        for k, v in js.full_batch().items():
            assert np.array_equal(ts.full_batch()[k], v)
    # A pure function of (seed, step): a rebuilt sampler draws the same.
    again = build_sampler(tdata, FANOUT, SEEDS, seed=7)
    assert np.array_equal(again.sample(3)["edge_keep"],
                          build_sampler(tdata, FANOUT, SEEDS, seed=7)
                          .sample(3)["edge_keep"])


def test_build_sampler_validates():
    _, _, tdata = _data()
    with pytest.raises(ValueError, match="fanout"):
        build_sampler(tdata, fanout=0, batch_seeds=4)
    with pytest.raises(ValueError, match="batch_seeds"):
        build_sampler(tdata, fanout=2, batch_seeds=0)
    s = build_sampler(tdata, fanout=2, batch_seeds=4)
    assert isinstance(s.in_valid, np.ndarray) and s.train_mask.dtype == bool


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

CASES = [
    ("gcn", "cv", "fp32", "none", True),
    ("gcn", "plain", "fp32", "none", True),
    ("gcn", "cv", "int8", "none", True),
    ("gcn", "cv", "bf16", "none", True),
    ("gcn", "cv", "fp32", "ema", True),
    ("sage", "cv", "fp32", "none", True),
    ("sage", "plain", "int8", "none", True),
    ("sage", "cv", "int8", "ema", True),
    ("gat", "cv", "fp32", "none", True),
    ("gat", "plain", "fp32", "none", True),
    ("gat", "cv", "int8", "ema", True),
    ("gat", "cv", "fp32", "ema", False),
]


@pytest.mark.parametrize("model,estimator,storage,predictor,dedup", CASES)
def test_sampled_steps_match_reference(model, estimator, storage, predictor,
                                       dedup):
    _, jdata, tdata = _data()
    jcfg, tcfg = _configs(model, gat_halo_dedup=dedup)
    jp, tp = _params(jcfg)
    kw = dict(storage=storage, predictor=predictor,
              sample_estimator=estimator)
    jset, tset = _settings(jdigest, **kw), _settings(tdigest, **kw)
    jopt = _capture(joptim, joptim.adam(5e-3))
    topt = _capture(toptim, toptim.adam(5e-3))
    jst = jdigest.init_sampled_state(jcfg, jopt, jdata,
                                     precision=jset.precision,
                                     predictor=jset.predictor)
    jst["params"], jst["opt_state"] = jp, jopt.init(jp)
    tst = tdigest.init_sampled_state(tcfg, topt, tdata,
                                     precision=tset.precision,
                                     predictor=tset.predictor, params=tp)
    assert sorted(tst) == sorted(jst)
    jfn = jax.jit(jdigest.make_sampled_epoch_fn(jcfg, jopt, jset))
    tfn = tdigest.make_sampled_epoch_fn(tcfg, topt, tset)
    jd = {k: v for k, v in jdata.items() if not k.startswith("_")}
    sampler = build_sampler(tdata, FANOUT, SEEDS, seed=3)
    for t in range(STEPS):
        batch = sampler.sample(t)
        jst, jm = jfn(jst, jd, {k: jax.numpy.asarray(v)
                                for k, v in batch.items()})
        tst, tm = tfn(tst, tdata, tdigest.batch_tensors(batch, "cpu"))
        if t == 0:
            for a, b in zip(jax.tree.leaves(jst["opt_state"]["grads"]),
                            _leaves(tst["opt_state"]["grads"])):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.numpy(), a, rtol=0,
                    atol=GRAD_TOL * max(np.abs(a).max(), 1e-30))
        assert np.isfinite(float(tm["loss"]))
        assert abs(float(jm["loss"]) - float(tm["loss"])) <= TRAJ_TOL
        assert abs(float(jm["train_f1"]) - float(tm["train_f1"])) <= TRAJ_TOL
        np.testing.assert_allclose(tm["staleness_eps"].numpy(),
                                   np.asarray(jm["staleness_eps"]), rtol=0,
                                   atol=TRAJ_TOL)
    # The history is the last step's push representations: within 1e-4,
    # or for the bf16 store within the store's own bar in
    # test_torch_train (2^-6 relative: a halo value 1e-7 from a bf16
    # rounding boundary may round the other way, one bf16 ulp, and the
    # representations downstream of it move by about that share).
    tol = (dict(rtol=2 ** -6, atol=1e-6) if storage == "bf16"
           else dict(rtol=0, atol=TRAJ_TOL))
    np.testing.assert_allclose(tst["hist"].numpy(), np.asarray(jst["hist"]),
                               **tol)


def test_sampled_train_with_faults_matches_reference():
    """The fault schedule and the watchdog act on the sampled step as on
    the full-batch epoch: the same push ages, losses within 1e-4."""
    _, jdata, tdata = _data()
    jcfg, tcfg = _configs("gcn")
    _, tp = _params(jcfg)
    fault = dict(seed=1, drop_push_rate=0.5, crash_rate=0.1)
    runs = []
    for module, data, cfg, opt, fmod, extra in (
            (jdigest, jdata, jcfg, joptim, jfaults, {}),
            (tdigest, tdata, tcfg, toptim, tfaults, {"params": tp})):
        sampler = (jbuild_sampler if module is jdigest else build_sampler)(
            data, FANOUT, SEEDS, seed=3)
        runs.append(module.sampled_train(
            cfg, opt.adam(5e-3), data, sampler,
            _settings(module, max_staleness=4), 8, eval_every=1,
            faults=fmod.FaultConfig(**fault), **extra)[1])
    (jh, th) = runs
    assert th["push_age"] == jh["push_age"] and max(th["push_age"]) < 4
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=TRAJ_TOL)


def test_reference_sampled_checkpoint_resumes_in_the_port(tmp_path):
    _, jdata, tdata = _data()
    jcfg, tcfg = _configs("sage")
    d = str(tmp_path)
    jsampler = jbuild_sampler(jdata, FANOUT, SEEDS, seed=3)
    _, jhist = jdigest.sampled_train(jcfg, joptim.adam(5e-3), jdata,
                                     jsampler, _settings(jdigest), 8,
                                     eval_every=1)
    jdigest.sampled_train(jcfg, joptim.adam(5e-3), jdata, jsampler,
                          _settings(jdigest), 4, eval_every=4, ckpt_dir=d,
                          ckpt_every=4)
    tst, thist = tdigest.sampled_train(
        tcfg, toptim.adam(5e-3), tdata,
        build_sampler(tdata, FANOUT, SEEDS, seed=3), _settings(tdigest), 8,
        eval_every=1, ckpt_dir=d, resume=True)
    assert thist["epoch"] == [5, 6, 7, 8] and tst["epoch"] == 8
    np.testing.assert_allclose(thist["loss"], jhist["loss"][4:], rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(thist["train_f1"], jhist["train_f1"][4:],
                               rtol=0, atol=TRAJ_TOL)


# ---------------------------------------------------------------------------
# Port against port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_full_coverage_equals_full_batch(model):
    _, jdata, tdata = _data()
    jcfg, tcfg = _configs(model)
    _, tp = _params(jcfg)
    sampler = _full_coverage(tdata)
    assert sampler.fanout >= sampler.max_in_degree
    full, full_h = tdigest.digest_train(tcfg, toptim.adam(5e-3), tdata,
                                        _settings(tdigest), 4, eval_every=1,
                                        params=tp)
    samp, samp_h = tdigest.sampled_train(tcfg, toptim.adam(5e-3), tdata,
                                         sampler, _settings(tdigest), 4,
                                         eval_every=1, params=tp)
    for key in ("params", "store", "cache", "opt_state"):
        if model == "gat":
            for a, b in zip(_leaves(full[key]), _leaves(samp[key])):
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
        else:
            assert _equal(full[key], samp[key]), key
    if model != "gat":
        assert full_h["loss"] == samp_h["loss"]


def test_random_history_changes_nothing_at_full_coverage():
    _, _, tdata = _data()
    _, cfg = _configs("sage")
    opt = toptim.adam(5e-3)
    batch = tdigest.batch_tensors(_full_coverage(tdata).sample(0), "cpu")
    step = tdigest.make_sampled_epoch_fn(cfg, opt, _settings(tdigest))
    state = tdigest.init_sampled_state(cfg, opt, tdata)
    s1, m1 = step(state, tdata, batch)
    noisy = dict(state)
    noisy["hist"] = torch.randn(state["hist"].shape,
                                generator=torch.Generator().manual_seed(3))
    s2, m2 = step(noisy, tdata, batch)
    assert _equal(s1["params"], s2["params"])
    assert _equal(s1["store"], s2["store"])
    assert torch.equal(m1["loss"], m2["loss"])


def test_cv_variance_below_plain():
    """At fanout 2 the CV step's SGD update is closer (MSE over 8 draws)
    to the exact full-coverage update than plain scaled sampling's."""
    _, _, tdata = _data()
    _, cfg = _configs("gcn")
    opt = toptim.sgd(0.1)
    full = _full_coverage(tdata)
    state, _ = tdigest.sampled_train(cfg, opt, tdata, full,
                                     _settings(tdigest), steps=6,
                                     eval_every=6)
    step_cv = tdigest.make_sampled_epoch_fn(cfg, opt, _settings(tdigest))
    step_plain = tdigest.make_sampled_epoch_fn(
        cfg, opt, _settings(tdigest, sample_estimator="plain"))
    ref = _leaves(step_cv(state, tdata, tdigest.batch_tensors(
        full.full_batch(), "cpu"))[0]["params"])

    def mse(st):
        return sum(float(((a - b) ** 2).sum())
                   for a, b in zip(_leaves(st["params"]), ref))

    sampler = build_sampler(tdata, fanout=2, batch_seeds=1 << 30, seed=11)
    err_cv = err_plain = 0.0
    for t in range(8):
        batch = tdigest.batch_tensors(sampler.sample(t), "cpu")
        err_cv += mse(step_cv(state, tdata, batch)[0])
        err_plain += mse(step_plain(state, tdata, batch)[0])
    assert err_cv < err_plain, (err_cv, err_plain)


@pytest.mark.parametrize("pred", [False, True])
def test_sampled_kill_and_resume_is_bitwise(tmp_path, pred):
    _, _, tdata = _data()
    _, cfg = _configs("gcn")
    sampler = build_sampler(tdata, FANOUT, SEEDS, seed=3)
    settings = _settings(tdigest, max_staleness=6,
                         predictor="ema" if pred else "none")
    kw = dict(eval_every=1, ckpt_every=2, faults=tfaults.FaultConfig(
        seed=1, drop_push_rate=0.5))

    def run(steps, ckpt, **extra):
        return tdigest.sampled_train(cfg, toptim.adam(5e-3), tdata, sampler,
                                     settings, steps, ckpt_dir=ckpt, **kw,
                                     **extra)

    full, full_h = run(8, str(tmp_path / "a"))
    run(4, str(tmp_path / "b"))
    resumed, res_h = run(8, str(tmp_path / "b"), resume=True)
    assert set(full) == set(resumed) and "hist" in resumed
    assert _equal(full, resumed)
    assert res_h["loss"] == full_h["loss"][4:]
    assert res_h["push_age"] == full_h["push_age"][4:]
    assert max(full_h["push_age"]) < 6
    assert tckpt.latest_step(str(tmp_path / "b")) == 8


def test_gat_in_pos_of_the_unremapped_ell_is_exact():
    """``sampled_struct`` keeps the struct's ``in_pos`` (the transpose of
    the unremapped in-ELL): a GAT layer's table and parameter gradients
    through it equal those through a transpose rebuilt from the remapped
    in-ELL, bit for bit."""
    _, _, tdata = _data()
    _, cfg = _configs("gat")
    _, tp = _params(_configs("gat")[0])
    rows = int(tdata["local_ids"].shape[1])
    sampler = build_sampler(tdata, 2, SEEDS, seed=5)
    batch = tdigest.batch_tensors(sampler.sample(0), "cpu")
    rng = np.random.default_rng(0)
    for m in range(2):
        struct = {k: v[m] for k, v in tdata["struct"].items()}
        view = tgnn.sampled_struct(struct, {
            "edge_scale": batch["edge_scale"][m],
            "edge_keep": batch["edge_keep"][m]}, rows)
        assert view["in_pos"] is struct["in_pos"]
        assert (view["in_nbr"] != struct["in_nbr"]).any()
        rebuilt = dict(view, in_pos=transpose_of(view["in_nbr"], rows + 1))
        x = torch.from_numpy(rng.normal(size=(rows, 16)).astype(np.float32))
        halo = torch.from_numpy(rng.normal(
            size=(tdata["halo_ids"].shape[1], 16)).astype(np.float32))
        gy = None
        grads = []
        for st in (view, rebuilt):
            p = {k: v.clone().requires_grad_()
                 for k, v in tp["layer_1"].items()}
            xx = x.clone().requires_grad_()
            out = tgnn._gat_layer(cfg, p, xx, halo, st)
            if gy is None:
                gy = torch.from_numpy(rng.normal(size=tuple(out.shape))
                                      .astype(np.float32))
            grads.append(torch.autograd.grad((out * gy).sum(),
                                             [xx, *p.values()]))
        assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_history_product_launches_no_backward(monkeypatch):
    """The history's K1 product is not differentiated: a CV step runs the
    table-gradient kernel as often as the full-batch epoch (once a hidden
    layer and subgraph) and the weight gradient never (gcn)."""
    spmm_module = importlib.import_module("repro_torch.kernels.spmm.spmm")
    calls = {"table": 0, "wts": 0}
    real_t, real_w = spmm_module.spmm_bwd_table, spmm_module.spmm_bwd_wts

    def spy_t(*a, **k):
        calls["table"] += 1
        return real_t(*a, **k)

    def spy_w(*a, **k):
        calls["wts"] += 1
        return real_w(*a, **k)

    monkeypatch.setattr(spmm_module, "spmm_bwd_table", spy_t)
    monkeypatch.setattr(spmm_module, "spmm_bwd_wts", spy_w)
    _, _, tdata = _data()
    _, cfg = _configs("gcn")
    opt = toptim.adam(5e-3)
    sampler = build_sampler(tdata, FANOUT, SEEDS, seed=3)
    counts = []
    for sampled in (False, True):
        calls.update(table=0, wts=0)
        if sampled:
            fn = tdigest.make_sampled_epoch_fn(cfg, opt, _settings(tdigest))
            fn(tdigest.init_sampled_state(cfg, opt, tdata), tdata,
               tdigest.batch_tensors(sampler.sample(0), "cpu"))
        else:
            tdigest.make_epoch_fn(cfg, opt, _settings(tdigest))(
                tdigest.init_state(cfg, opt, tdata), tdata)
        counts.append(dict(calls))
    assert counts[0] == counts[1] == {"table": 2 * 2, "wts": 0}


def test_sampled_settings_are_checked():
    _, _, tdata = _data()
    _, cfg = _configs("gcn")
    opt = toptim.adam(5e-3)
    with pytest.raises(ValueError, match="digest"):
        tdigest.make_sampled_epoch_fn(cfg, opt,
                                      _settings(tdigest, mode="partition"))
    with pytest.raises(ValueError, match="sample_estimator"):
        tdigest.make_sampled_epoch_fn(
            cfg, opt, _settings(tdigest, sample_estimator="x"))
    with pytest.raises(ValueError, match="needs the mesh"):
        tdigest.make_sampled_epoch_fn(
            cfg, opt, _settings(tdigest, pull_mode="collective"))
    with pytest.raises(ValueError, match="a mesh is for"):
        tdigest.sampled_train(cfg, opt, tdata, None, _settings(tdigest), 1,
                              mesh=object())
    state = tdigest.init_sampled_state(cfg, opt, tdata)
    m, s = tdata["local_ids"].shape
    assert tuple(state["hist"].shape) == (m, 2, s, 16)
    assert state["hist"].dtype == torch.float32 and not state["hist"].any()
    assert dataclasses.replace(_settings(tdigest)).sample_estimator == "cv"


def test_train_gnn_sampling_on_cpu(capsys, tmp_path):
    args = ["--device", "cpu", "--scale", "0.15", "--parts", "2",
            "--interval", "2", "--sampling", "--fanout", "3",
            "--batch-seeds", "64", "--fault-drop-rate", "0.3",
            "--max-staleness", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train_gnn.main(args + ["--epochs", "4"])
    out = capsys.readouterr().out
    assert "sampling: fanout=3 (max in-degree" in out
    assert "batch_seeds=64, estimator=cv" in out
    assert "device=cpu epochs=4" in out and "halo worklist" in out
    assert "fault staleness: max push age" in out
    train_gnn.main(args + ["--epochs", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resume: restored step 4" in out and "epochs=6" in out
    assert tckpt.latest_step(str(tmp_path)) == 6
    train_gnn.main(["--device", "cpu", "--scale", "0.15", "--parts", "2",
                    "--epochs", "2", "--sampling", "--estimator", "plain",
                    "--model", "gat", "--precision", "int8"])
    assert "estimator=plain" in capsys.readouterr().out
