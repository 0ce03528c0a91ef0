"""The SAT predictor in the port against the reference.

``update_history`` is held to the reference's over a random sequence of
pushes with random ``ok`` masks: ``prev``, ``ema`` and the emitted rows
within 1e-6, ``coef`` within 1e-5 (it is a ratio of two fp32 sums over
(S, hidden), taken in another order, and then EMA-smoothed), ``count``
exactly.  The port's own guarantees are held port against port, bit for
bit: ``kind="none"`` is inert whatever gamma and beta are, and an enabled
predictor with gamma = 0 leaves params, store, cache and optimizer state
as the predictor-free run's.

A predictor training run (flickr-sim at scale 0.15, 2 parts, GCN 3 x 16,
interval 2, 8 epochs) against ``repro.core.digest_train`` with the same
parameters: the loss trajectory within 1e-4; the pstore within 1e-5 for
fp32, and for int8 within one code and one scale step (the reference's
jitted ``max(amax, 1e-12)/127`` is not always the correctly rounded
quotient, ROADMAP §3), read as its dequantised rows within 1e-5 plus one
scale step.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch import optim as toptim
from repro_torch.core import digest as tdigest
from repro_torch.core import halo_exchange as thx
from repro_torch.core import predictor as tpred
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

TRAJ_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _data(parts=2):
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return (g, jdigest.prepare_graph_data(g, parts, seed=0),
            tdigest.prepare_graph_data(g, parts, seed=0, device="cpu"))


def _configs(g, model="gcn", **kw):
    base = dict(model=model, num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1, heads=2)
    base.update(kw)
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


@pytest.mark.parametrize("kind", ["delta", "ema"])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_history_matches_reference(kind, seed):
    M, L1, S, H = 3, 2, 7, 5
    rng = np.random.default_rng(seed)
    jc = jpred.PredictorConfig(kind=kind, beta=0.3)
    tc = tpred.PredictorConfig(kind=kind, beta=0.3)
    jh = jpred.init_history(M, L1, S, H)
    th = tpred.init_history(M, L1, S, H, "cpu")
    base = rng.normal(size=(M, L1, S, H)).astype(np.float32)
    step = rng.normal(size=(M, L1, S, H)).astype(np.float32)
    for t in range(12):
        # A drifting trajectory with noise, so that the fit has signal.
        reps = (base + t * step + 0.3 * rng.normal(size=base.shape)
                ).astype(np.float32)
        ok = rng.random(M) < 0.7
        jh, jrows = jpred.update_history(jh, jnp.asarray(reps),
                                         jnp.asarray(ok), jc)
        th, trows = tpred.update_history(th, torch.from_numpy(reps),
                                         torch.from_numpy(ok), tc)
        np.testing.assert_allclose(trows.numpy(), np.asarray(jrows),
                                   rtol=0, atol=1e-6)
        for leaf, tol in (("prev", 1e-6), ("ema", 1e-6), ("coef", 1e-5)):
            np.testing.assert_allclose(th[leaf].numpy(),
                                       np.asarray(jh[leaf]), rtol=0,
                                       atol=tol, err_msg=leaf)
        np.testing.assert_array_equal(th["count"].numpy(),
                                      np.asarray(jh["count"]))
    assert th["count"].dtype == torch.int32
    assert float(th["coef"].abs().max()) > 0


def test_update_history_is_pure_and_masked():
    M, L1, S, H = 3, 2, 5, 4
    cfg = tpred.PredictorConfig(kind="ema", beta=0.5)
    gen = torch.Generator().manual_seed(0)
    seq = [torch.randn((M, L1, S, H), generator=gen) for _ in range(4)]
    hist = tpred.init_history(M, L1, S, H, "cpu")
    for reps in seq[:3]:
        hist, _ = tpred.update_history(hist, reps, torch.ones(M, dtype=bool),
                                       cfg)
    before = {k: v.clone() for k, v in hist.items()}
    frozen, _ = tpred.update_history(hist, seq[3],
                                     torch.tensor([True, False, True]), cfg)
    assert _equal(hist, before)                   # nothing written in place
    for leaf in ("prev", "ema", "coef", "count"):
        assert torch.equal(frozen[leaf][1], hist[leaf][1]), leaf
    assert not torch.equal(frozen["prev"][0], hist["prev"][0])


@pytest.mark.parametrize("kind", ["delta", "ema"])
def test_first_pushes_emit_zero_rows(kind):
    M, L1, S, H = 2, 1, 4, 3
    cfg = tpred.PredictorConfig(kind=kind)
    hist = tpred.init_history(M, L1, S, H, "cpu")
    gen = torch.Generator().manual_seed(1)
    for _ in range(2):
        hist, rows = tpred.update_history(
            hist, torch.randn((M, L1, S, H), generator=gen),
            torch.ones(M, dtype=bool), cfg)
        assert not bool(rows.any())
    assert not bool(hist["coef"].any())


def test_coef_learns_linear_trajectory():
    M, L1, S, H = 2, 2, 4, 3
    cfg = tpred.PredictorConfig(kind="delta", beta=0.5)
    v = torch.randn((M, L1, S, H), generator=torch.Generator().manual_seed(2))
    hist = tpred.init_history(M, L1, S, H, "cpu")
    ok = torch.ones(M, dtype=bool)
    coefs, rows = [], None
    for t in range(1, 7):
        hist, rows = tpred.update_history(hist, t * v, ok, cfg)
        coefs.append(float(hist["coef"].min()))
    assert coefs[0] == coefs[1] == 0.0
    assert all(b > a for a, b in zip(coefs[2:], coefs[3:]))
    assert coefs[-1] == pytest.approx(1.0, abs=0.1)
    raw_err = torch.linalg.vector_norm(7 * v - 6 * v)
    pred_err = torch.linalg.vector_norm(7 * v - (6 * v + rows))
    assert pred_err < 0.2 * raw_err
    hist2, _ = tpred.update_history(hist, -100 * v, ok, cfg)
    assert bool((hist2["coef"] >= tpred.COEF_MIN).all())
    assert bool((hist2["coef"] <= tpred.COEF_MAX).all())


@pytest.mark.parametrize("kw", [dict(kind="linear"),
                                dict(kind="ema", beta=0.0),
                                dict(kind="ema", beta=1.5)])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError) as jerr:
        jpred.PredictorConfig(**kw)
    with pytest.raises(ValueError) as terr:
        tpred.PredictorConfig(**kw)
    assert str(terr.value) == str(jerr.value)
    assert not tpred.PredictorConfig().enabled
    assert tpred.PredictorConfig(kind="ema").enabled
    assert (tpred.KINDS, tpred.COEF_MIN, tpred.COEF_MAX) == (
        jpred.KINDS, jpred.COEF_MIN, jpred.COEF_MAX)


def _port_run(pcfg, epochs=8, storage="fp32", model="gcn"):
    g, _, tdata = _data()
    _, cfg = _configs(g, model)
    settings = tdigest.TrainSettings(
        sync_interval=2, precision=thx.HaloPrecision(storage),
        predictor=pcfg)
    return tdigest.digest_train(cfg, toptim.adam(5e-3), tdata, settings,
                                epochs, eval_every=1)


def test_none_is_inert_and_gamma0_additive():
    base, base_hist = _port_run(tpred.PredictorConfig())
    assert "pstore" not in base and "predictor" not in base
    off, _ = _port_run(tpred.PredictorConfig(kind="none", gamma=7.0,
                                             beta=0.9))
    assert _equal(base, off)
    g0, g0_hist = _port_run(tpred.PredictorConfig(kind="ema", gamma=0.0))
    for key in ("params", "store", "cache", "opt_state"):
        assert _equal(base[key], g0[key]), key
    assert base_hist["loss"] == g0_hist["loss"]
    assert {"pstore", "predictor", "pcache"} <= set(g0)
    assert int(g0["predictor"]["count"].min()) > 0
    on, _ = _port_run(tpred.PredictorConfig(kind="ema"))
    assert not _equal(base["params"], on["params"])


def test_predictor_outside_digest_mode_raises():
    g, _, _ = _data()
    _, cfg = _configs(g)
    for mode in ("partition", "propagation"):
        with pytest.raises(ValueError, match="predictor"):
            tdigest.make_epoch_fn(cfg, toptim.adam(5e-3),
                                  tdigest.TrainSettings(
                                      mode=mode,
                                      predictor=tpred.PredictorConfig("ema")))


@pytest.mark.parametrize("storage,model,dedup", [
    ("fp32", "gcn", True), ("int8", "gcn", True), ("fp32", "gat", True),
    ("fp32", "gat", False), ("bf16", "sage", True)])
def test_predictor_training_matches_reference(storage, model, dedup):
    """GAT with the dedup folds the prediction into the owner-shard
    projection; without it the layer reads the pulled pcache slab."""
    g, jdata, tdata = _data()
    jcfg, tcfg = _configs(g, model, gat_halo_dedup=dedup)
    jp = init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(sync_interval=2)
    jset = jdigest.TrainSettings(precision=jhx.HaloPrecision(storage),
                                 predictor=jpred.PredictorConfig("ema"), **kw)
    tset = tdigest.TrainSettings(precision=thx.HaloPrecision(storage),
                                 predictor=tpred.PredictorConfig("ema"), **kw)
    jst, jh = jdigest.digest_train(jcfg, joptim.adam(5e-3), jdata, jset, 8,
                                   eval_every=1)
    tst, th = tdigest.digest_train(tcfg, toptim.adam(5e-3), tdata, tset, 8,
                                   eval_every=1, params=tp)
    assert len(th["loss"]) == 8
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=0, atol=TRAJ_TOL)
    np.testing.assert_allclose(th["train_f1"], jh["train_f1"], rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_allclose(np.array(th["staleness_eps"]),
                               np.array(jh["staleness_eps"]), rtol=0,
                               atol=TRAJ_TOL)
    np.testing.assert_array_equal(tst["predictor"]["count"].numpy(),
                                  np.asarray(jst["predictor"]["count"]))
    assert float(tst["predictor"]["coef"].abs().max()) > 0
    np.testing.assert_allclose(tst["predictor"]["coef"].numpy(),
                               np.asarray(jst["predictor"]["coef"]), rtol=0,
                               atol=1e-4)
    jps, tps = jst["pstore"], tst["pstore"]
    jrows = np.asarray(jhx.dequantize_rows(jps["data"], jps.get("scale")))
    trows = thx.dequantize_rows(tps["data"], tps.get("scale")).numpy()
    if storage == "int8":
        codes = tps["data"].numpy().astype(int) - np.asarray(
            jps["data"]).astype(int)
        assert np.abs(codes).max() <= 1
        step = np.asarray(jps["scale"])
        assert np.all(np.abs(trows - jrows) <= 1e-5 + 1.01 * step)
    elif storage == "bf16":
        np.testing.assert_allclose(trows, jrows, rtol=2 ** -6, atol=1e-5)
    else:
        np.testing.assert_allclose(trows, jrows, rtol=0, atol=1e-5)
    assert ("pcache" in tst) == (model != "gat" or not dedup)


@pytest.mark.parametrize("storage,without,with_pdata", [
    ("fp32", "skip", "skip"), ("int8", "resident", "resident"),
    ("bf16", "resident", "skip")])
def test_selection_with_the_predictor_slab(storage, without, with_pdata):
    """The ladder at the training path's halo slab (papers-sim, 8 parts,
    rcm, 256-row chunks: 14,289 rows of 128, worklist occupancy 0.475):
    the pdata slab doubles the stripe, so the bf16 store, resident (K1)
    without a predictor, streams through K4 with one; fp32 stays on K4
    and int8 on K2 (3.77 MB, under the 4 MiB budget)."""
    from repro_torch.kernels.spmm import select_halo_kernel
    data, scale = thx.quantize_rows(torch.zeros((14289, 128)),
                                    thx.HaloPrecision(storage))
    kw = dict(has_worklist=True, occupancy=0.475)
    assert select_halo_kernel(data, scale, **kw) == without
    assert select_halo_kernel(data, scale, data, scale, **kw) == with_pdata
