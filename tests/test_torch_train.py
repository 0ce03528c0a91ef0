"""Full-batch DIGEST training in the port against the reference.

The same graph, partition and parameters (the reference's
``init_params`` → numpy → ``params_from_numpy``) go through the JAX
package's jitted ``make_epoch_fn`` (``backend="jnp"``, its gather-form
oracles) and the port's epoch on CPU tensors (its kernels' plain
versions), on flickr-sim at scale 0.15, 2-3 parts, 3 layers of width 16,
6 epochs with ``sync_interval=2`` (pulls at r = 2, 4, 6; pushes at r = 1,
3, 5).  Both optimizers keep the mean gradient of their last update, so
epoch 1's per-leaf gradients are compared directly.

Tolerances: epoch-1 gradients within 1e-5 of each leaf's max |g|; the
loss, train F1 and per-layer staleness trajectories within 1e-4 absolute
for every store.  What was measured on this CPU: at most 2.4e-7 for fp32
losses, 1.6e-6 for bf16, 2.4e-7 for int8 (no code flipped), train F1
equal.  The store ops are held to JAX within 1e-6 and int8 codes bit for
bit.
"""
import dataclasses
import functools
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import halo_exchange as jhx
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params
from repro_torch import checkpoint as tckpt
from repro_torch import optim as toptim
from repro_torch.core import digest as tdigest
from repro_torch.core import halo_exchange as thx
from repro_torch.core import predictor as tpredictor
from repro_torch.kernels.spmm import ops as tops
from repro_torch.kernels.spmm import select_halo_kernel
from repro_torch.launch import quickstart, train_gnn
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

EPOCHS = 6
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-4


@functools.lru_cache(maxsize=None)
def _data(parts=2, chunk_rows=None, order="none"):
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    kw = dict(seed=0, stream_chunk_rows=chunk_rows, order=order)
    return (g, jdigest.prepare_graph_data(g, parts, **kw),
            tdigest.prepare_graph_data(g, parts, device="cpu", **kw))


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


def _configs(g, model, **kw):
    base = dict(model=model, num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1, heads=2)
    base.update(kw)
    return jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)


def _run_both(model, storage, mode="digest", parts=2, chunk_rows=None,
              order="none", error_feedback=False, cfg_kw=None,
              llcg=False):
    g, jdata, tdata = _data(parts, chunk_rows, order)
    cfg_kw = dict(cfg_kw or {})
    if chunk_rows is not None:
        cfg_kw.update(stream_chunk_rows=chunk_rows,
                      halo_occupancy=tdata["_worklist"].occupancy)
    jcfg, tcfg = _configs(g, model, **cfg_kw)
    jp = init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    set_kw = dict(sync_interval=2, mode=mode, llcg_correction=llcg,
                  correction_frac=0.5, correction_lr=0.05)
    jset = jdigest.TrainSettings(precision=jhx.HaloPrecision(
        storage, error_feedback), **set_kw)
    tset = tdigest.TrainSettings(precision=thx.HaloPrecision(
        storage, error_feedback), **set_kw)
    jopt = _capture(joptim, joptim.adam(5e-3))
    topt = _capture(toptim, toptim.adam(5e-3))
    jst = jdigest.init_state(jcfg, jopt, jdata, precision=jset.precision)
    jst["params"], jst["opt_state"] = jp, jopt.init(jp)
    tst = tdigest.init_state(tcfg, topt, tdata, precision=tset.precision,
                             params=tp)
    jfn = jax.jit(jdigest.make_epoch_fn(jcfg, jopt, jset))
    tfn = tdigest.make_epoch_fn(tcfg, topt, tset)
    jd = {k: v for k, v in jdata.items() if not k.startswith("_")}
    traj = []
    for e in range(EPOCHS):
        jst, jm = jfn(jst, jd)
        tst, tm = tfn(tst, tdata)
        if e == 0:
            for a, b in zip(jax.tree.leaves(jst["opt_state"]["grads"]),
                            _leaves(tst["opt_state"]["grads"])):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.numpy(), a, rtol=0,
                    atol=GRAD_TOL * max(np.abs(a).max(), 1e-30))
        traj.append((float(jm["loss"]), float(tm["loss"]),
                     float(jm["train_f1"]), float(tm["train_f1"]),
                     np.asarray(jm["staleness_eps"]),
                     tm["staleness_eps"].numpy()))
    for jl, tl, jf, tf, je, te in traj:
        assert np.isfinite(tl)
        assert abs(jl - tl) <= TRAJ_TOL
        assert abs(jf - tf) <= TRAJ_TOL
        np.testing.assert_allclose(te, je, rtol=0, atol=TRAJ_TOL)
    return jst, tst, tdata, tcfg


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("model", ["gcn", "sage", "gat"])
def test_digest_epochs_match_reference(model, storage):
    jst, tst, _, _ = _run_both(model, storage)
    # The stores after three pushes, as the reference holds them: fp32
    # rows within 1e-5, bf16 within one bf16 ulp (at most 2^-6 of the
    # smaller value: a rep 1e-7 from a rounding boundary may round the
    # other way).
    ja, ta = jst["store"]["data"], tst["store"]["data"]
    if storage == "int8":
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    else:
        tol = (dict(rtol=0, atol=1e-5) if storage == "fp32"
               else dict(rtol=2 ** -6, atol=1e-6))
        np.testing.assert_allclose(ta.float().numpy(),
                                   np.asarray(ja.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("mode", ["partition", "propagation"])
def test_baseline_modes_match_reference(mode):
    _run_both("gcn", "fp32", mode=mode)


def test_gat_without_dedup_matches_reference():
    _run_both("gat", "fp32", cfg_kw=dict(gat_halo_dedup=False))


def test_error_feedback_matches_reference():
    """The residual is ``reps - dequant(quant(reps))`` of the last push
    (r = 5): the reps have drifted apart by up to ~1e-6 over four Adam
    steps, and that drift passes into the residual whole, hence 1e-5."""
    jst, tst, _, _ = _run_both("gcn", "int8", error_feedback=True)
    np.testing.assert_allclose(tst["push_residual"].numpy(),
                               np.asarray(jst["push_residual"]), rtol=0,
                               atol=1e-5)


def test_forced_skip_rung_matches_reference(monkeypatch):
    """A tiny resident budget and ``skip_occupancy_max=1.0`` put the
    hidden layers' halo products on K4 (its plain version here), held to
    the reference's oracle epoch."""
    calls = []
    real = tops.halo_spmm_skip_cuda

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tops, "halo_spmm_skip_cuda", spy)
    _, _, tdata = _data(3, 32, "rcm")
    slab = torch.zeros((tdata["halo_ids"].shape[1] + 1, 16))
    kw = dict(resident_max_bytes=64, skip_occupancy_max=1.0)
    assert select_halo_kernel(
        slab, has_worklist=True, occupancy=tdata["_worklist"].occupancy,
        **kw) == "skip"
    assert tdata["_worklist"].n_chunks > 1
    _run_both("gcn", "fp32", parts=3, chunk_rows=32, order="rcm",
              cfg_kw=kw)
    # Two hidden layers x 3 subgraphs x 6 epochs, and the evaluations'.
    assert len(calls) >= 2 * 3 * EPOCHS


def test_llcg_correction_matches_reference(monkeypatch):
    """The server step on the reference's own sample (the port draws its
    batch from torch.Generator; here it is handed jax.random's)."""
    def jax_sample(n, frac, r):
        key = jax.random.fold_in(jax.random.PRNGKey(17), r)
        return torch.from_numpy(np.array(
            jax.random.uniform(key, (n,)) < frac))

    monkeypatch.setattr(tdigest, "llcg_sample", jax_sample)
    jst, tst, _, _ = _run_both("gcn", "fp32", mode="partition", llcg=True)
    for a, b in zip(jax.tree.leaves(jst["params"]), _leaves(tst["params"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_store_ops_match_reference():
    _, jdata, tdata = _data()
    rng = np.random.default_rng(9)
    m, s = tdata["local_slots"].shape
    rows = int(tdata["store_ids"].shape[0])
    reps = rng.normal(size=(m, 2, s, 8)).astype(np.float32)
    resid = (0.01 * rng.normal(size=reps.shape)).astype(np.float32)
    for storage in ("fp32", "bf16", "int8"):
        jp, tp = jhx.HaloPrecision(storage), thx.HaloPrecision(storage)
        js = jhx.init_store(2, rows - 1, 8, jp)
        ts = thx.init_store(2, rows - 1, 8, tp, "cpu")
        js, jr = jhx.push_ef(js, jdata["local_slots"], jdata["local_valid"],
                             jnp.asarray(reps), jnp.asarray(resid),
                             jdata["sentinel_slots"])
        ts, tr = thx.push_ef(ts, tdata["local_slots"], tdata["local_valid"],
                             torch.from_numpy(reps), torch.from_numpy(resid),
                             tdata["sentinel_slots"])
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0,
                                   atol=1e-6)
        if storage == "int8":
            np.testing.assert_array_equal(ts["data"].numpy(),
                                          np.asarray(js["data"]))
        js_, ts_ = jhx.pull_slab(js, jdata["halo_slots"]), thx.pull_slab(
            ts, tdata["halo_slots"])
        assert set(js_) == set(ts_)
        for k in js_:
            np.testing.assert_allclose(ts_[k].float().numpy(),
                                       np.asarray(js_[k].astype(jnp.float32)),
                                       rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            thx.pull(ts, tdata["halo_slots"]).numpy(),
            np.asarray(jhx.pull(js, jdata["halo_slots"])), rtol=1e-6,
            atol=0)
        fresh = rng.normal(size=reps.shape).astype(np.float32)
        np.testing.assert_allclose(
            thx.staleness_error(ts, torch.from_numpy(fresh),
                                tdata["local_slots"],
                                tdata["local_boundary"]).numpy(),
            np.asarray(jhx.staleness_error(js, jnp.asarray(fresh),
                                           jdata["local_slots"],
                                           jdata["local_boundary"])),
            rtol=1e-6, atol=0)
        jslab = jhx.init_slab(m, 2, 5, 8, jp)
        tslab = thx.init_slab(m, 2, 5, 8, tp, "cpu")
        assert set(jslab) == set(tslab)
        for k in jslab:
            assert tuple(tslab[k].shape) == jslab[k].shape
            np.testing.assert_array_equal(
                tslab[k].float().numpy(),
                np.asarray(jslab[k].astype(jnp.float32)))


def test_halo_spec_matches_reference():
    _, jdata, _ = _data()
    sp = jdata["_sp"]
    for storage in ("fp32", "bf16", "int8"):
        j = jhx.HaloSpec.from_partitions(sp, 16, 3, jhx.HaloPrecision(storage))
        t = thx.HaloSpec.from_partitions(sp, 16, 3, thx.HaloPrecision(storage))
        assert t.store_nbytes() == j.store_nbytes()
        assert t.shard_nbytes() == j.shard_nbytes()
        assert t.dense_nbytes(100) == j.dense_nbytes(100)
        assert t.replicated_pull_nbytes() == j.replicated_pull_nbytes()
        assert t.comm_bytes(sp.pull_rows(), sp.push_rows()) == \
            j.comm_bytes(sp.pull_rows(), sp.push_rows())
        ts = t.init("cpu")
        assert tuple(ts["data"].shape) == j.init()["data"].shape


def test_train_settings_match_reference():
    """The same field names, in the same order, with the same defaults:
    a positional TrainSettings means the same run in both packages."""
    jf = dataclasses.fields(jdigest.TrainSettings)
    tf = dataclasses.fields(tdigest.TrainSettings)
    assert [f.name for f in tf] == [f.name for f in jf]
    jd, td = jdigest.TrainSettings(), tdigest.TrainSettings()
    for f in tf:
        want, got = getattr(jd, f.name), getattr(td, f.name)
        if dataclasses.is_dataclass(got):
            assert dataclasses.asdict(got) == dataclasses.asdict(want), f.name
        else:
            assert got == want, f.name


def test_nn_exports_match_reference():
    """Every name of ``repro.nn.__all__`` is exported by the port's."""
    import repro.nn as jnn
    import repro_torch.nn as tnn
    assert set(jnn.__all__) <= set(tnn.__all__)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_reference(dtype):
    """``layer_norm`` (statistics in fp32) and ``gelu_mlp`` (the tanh
    gelu) on the same numpy inputs, within 1e-6 of the reference's max
    |out|; in bf16 ``layer_norm`` too (both round the same fp32 values
    once), ``gelu_mlp`` within 2^-7: XLA rounds the gelu's intermediate
    steps to bf16 where torch rounds its result once, so a hidden element
    may differ by one bf16 ulp (2^-8 relative), which the down
    projection carries to the output (the MoE tests' bf16 bar)."""
    import repro.nn as jnn
    import repro_torch.nn as tnn
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 6, 32)).astype(np.float32) * 3 + 1
    scale, bias = (rng.normal(size=32).astype(np.float32) for _ in "ab")
    w_up = (rng.normal(size=(32, 64)) * 0.2).astype(np.float32)
    w_down = (rng.normal(size=(64, 32)) * 0.2).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))

    def rel(got, want):
        want = np.asarray(want.astype(jnp.float32))
        return float(np.abs(got.float().numpy() - want).max()
                     / np.abs(want).max())

    want = jnn.layer_norm(jx, jnp.asarray(scale), jnp.asarray(bias))
    got = tnn.layer_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == tx.dtype and rel(got, want) <= 1e-6
    want = jnn.gelu_mlp(jx, jnp.asarray(w_up).astype(dtype),
                        jnp.asarray(w_down).astype(dtype))
    got = tnn.gelu_mlp(tx, torch.from_numpy(w_up).to(tx.dtype),
                       torch.from_numpy(w_down).to(tx.dtype))
    assert got.dtype == tx.dtype
    assert rel(got, want) <= (1e-6 if dtype == "float32" else 2.0 ** -7)


def test_param_axes_and_abstract_params_match_reference():
    """``param_axes`` and ``abstract_params`` of a transformer's spec tree:
    the reference's axes leaf for leaf; shapes and dtypes on the meta
    device, nothing allocated."""
    from repro.configs import get_smoke_arch as jget
    from repro.models import transformer as jt
    import repro.nn as jnn
    from repro_torch.configs import get_smoke_arch as tget
    from repro_torch.models import transformer as tt
    import repro_torch.nn as tnn
    jspecs = jt.arch_specs(jget("llama4_scout_17b_a16e"))
    tspecs = tt.arch_specs(tget("llama4_scout_17b_a16e"))
    want = jax.tree.leaves(jnn.param_axes(jspecs),
                           is_leaf=lambda v: isinstance(v, tuple))
    def axes(node):
        if isinstance(node, dict):
            return [a for k in sorted(node) for a in axes(node[k])]
        if isinstance(node, list):
            return [a for v in node for a in axes(v)]
        return [node]

    assert axes(tnn.param_axes(tspecs)) == want
    shapes = [(tuple(s.shape), np.dtype(s.dtype).name)
              for s in jax.tree.leaves(jnn.abstract_params(jspecs))]
    meta = toptim.tree_leaves(tnn.abstract_params(tspecs))
    assert all(t.device.type == "meta" for t in meta)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for t in meta] == shapes


def test_core_exports_match_reference():
    """Every name of the reference's ``repro.core.__all__`` is exported by
    the port's, but for the dense oracle ``stale_store`` (not ported, by
    design); the sharded serving engine and the collective geometry check
    (ROADMAP §1 item 6) are ported."""
    import repro.core as jcore
    import repro_torch.core as tcore
    unported = {"stale_store"}
    assert set(jcore.__all__) - set(tcore.__all__) == unported
    for name in set(jcore.__all__) - unported:
        assert hasattr(tcore, name), name


def test_later_slices_raise(tmp_path):
    """Every slice is ported now; what stays is that the collective pull
    (ROADMAP §1 item 6, ported since) never quietly becomes the
    single-process loop: without a mesh, with a mesh under
    ``pull_mode="gather"`` or without a process group it raises, in the
    full-batch epoch, ``digest_train`` and the sampled step; the
    predictor, the watchdog and checkpoints (items 3 and 5) and the
    sampled regime (item 4) run."""
    g, _, tdata = _data()
    _, cfg = _configs(g, "gcn")
    opt = toptim.adam(5e-3)
    coll = tdigest.TrainSettings(pull_mode="collective")
    with pytest.raises(ValueError, match="needs the mesh"):
        tdigest.make_epoch_fn(cfg, opt, coll)
    with pytest.raises(ValueError, match="a mesh is for"):
        tdigest.digest_train(cfg, opt, tdata, tdigest.TrainSettings(), 1,
                             mesh=object())
    with pytest.raises(ValueError, match="needs the mesh"):
        tdigest.make_sampled_epoch_fn(cfg, opt, coll)
    with pytest.raises(RuntimeError, match="process group"):
        tdigest.make_epoch_fn(cfg, opt, coll, mesh=object())
    with pytest.raises(ValueError):
        tdigest.make_epoch_fn(cfg, opt, tdigest.TrainSettings(mode="x"))
    assert callable(tdigest.make_sampled_epoch_fn(
        cfg, opt, tdigest.TrainSettings()))
    settings = tdigest.TrainSettings(
        sync_interval=2, max_staleness=3,
        predictor=tpredictor.PredictorConfig("delta"))
    state, hist = tdigest.digest_train(cfg, opt, tdata, settings, 2,
                                       eval_every=1,
                                       ckpt_dir=str(tmp_path), ckpt_every=1)
    assert {"pstore", "predictor", "pcache", "last_push_round"} <= set(state)
    assert hist["push_age"] == [0, 1]
    assert tckpt.latest_step(str(tmp_path)) == 2
    bad = dataclasses.replace(cfg, stream_chunk_rows=64)
    with pytest.raises(ValueError, match="chunk_rows"):
        tdigest.init_state(bad, opt, tdata)


def test_digest_train_history():
    g, _, tdata = _data()
    _, cfg = _configs(g, "gcn")
    state, hist = tdigest.digest_train(cfg, toptim.adam(5e-3), tdata,
                                       tdigest.TrainSettings(sync_interval=2),
                                       epochs=4, eval_every=2)
    assert hist["epoch"] == [2, 4] and state["epoch"] == 4
    assert all(np.isfinite(hist["loss"])) and len(hist["val_f1"]) == 2


def test_train_gnn_launcher_on_cpu(capsys, tmp_path):
    train_gnn.main(["--device", "cpu", "--scale", "0.15", "--parts", "2",
                    "--epochs", "3", "--interval", "2", "--precision",
                    "int8", "--order", "rcm", "--stream-chunk-rows", "64"])
    out = capsys.readouterr().out
    assert "device=cpu epochs=3" in out and "halo worklist" in out
    quickstart.main(["--device", "cpu", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "digest" in out and "partition" in out
    ckpt = ["--device", "cpu", "--scale", "0.15", "--parts", "2",
            "--interval", "2", "--predictor", "ema", "--fault-drop-rate",
            "0.3", "--max-staleness", "4", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train_gnn.main(ckpt + ["--epochs", "4"])
    out = capsys.readouterr().out
    assert "predictor: kind=ema" in out and "faults: crash=0.0 drop=0.3" in out
    assert "fault staleness: max push age" in out and "(bound 4)" in out
    assert tckpt.latest_step(str(tmp_path)) == 4
    train_gnn.main(ckpt + ["--epochs", "6", "--resume"])
    out = capsys.readouterr().out
    assert "resume: restored step 4" in out and "epochs=6" in out
    assert tckpt.latest_step(str(tmp_path)) == 6


@pytest.mark.parametrize("model,dedup", [("gcn", True), ("sage", True),
                                         ("gat", True), ("gat", False)])
def test_epoch_gathers_through_the_struct_transposes(monkeypatch, model,
                                                     dedup):
    """Every differentiated SpMM and GAT score gather of the epoch (and of
    the LLCG server step's full-graph forward) finds its transposed ELL in
    the struct: no host transpose is built on the training path."""
    spmm_module = importlib.import_module("repro_torch.kernels.spmm.spmm")

    def refuse(*a, **k):
        raise AssertionError("a transposed ELL was built on the host")

    monkeypatch.setattr(spmm_module, "transpose_of", refuse)
    monkeypatch.setattr(tgnn, "transpose_of", refuse)
    g, _, tdata = _data()
    _, cfg = _configs(g, model, gat_halo_dedup=dedup)
    opt = toptim.adam(5e-3)
    settings = tdigest.TrainSettings(sync_interval=1, llcg_correction=True)
    state = tdigest.init_state(cfg, opt, tdata)
    epoch_fn = tdigest.make_epoch_fn(cfg, opt, settings)
    for _ in range(2):
        state, m = epoch_fn(state, tdata)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("storage", ["fp32", "int8"])
def test_project_store_tables_matches_reference(storage):
    """GAT's owner-shard projection: z = dequant(store) · W re-encoded in
    the wire precision (fp32 rows within 1e-6, int8 codes bit for bit
    but for a rounding tie moved by the product's order: at most 1)."""
    g, _, _ = _data()
    jcfg, tcfg = _configs(g, "gat")
    jp = init_params(jax.random.PRNGKey(2), jgnn.gnn_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(8)
    rows = rng.normal(size=(2, 40, 16)).astype(np.float32)
    jprec, tprec = jhx.HaloPrecision(storage), thx.HaloPrecision(storage)
    jq, js = jhx.quantize_rows(jnp.asarray(rows), jprec)
    tq, ts = thx.quantize_rows(torch.from_numpy(rows), tprec)
    jstore = {"data": jq} if js is None else {"data": jq, "scale": js}
    tstore = {"data": tq} if ts is None else {"data": tq, "scale": ts}
    jz = jdigest.project_store_tables(jstore, jp, jcfg, jprec)
    tz = tdigest.project_store_tables(tstore, tp, tcfg, tprec)
    assert sorted(jz) == sorted(tz) == ["z0", "z1"]
    for key in jz:
        for leaf in jz[key]:
            want = np.asarray(jz[key][leaf])
            got = tz[key][leaf].numpy()
            assert got.shape == want.shape and got.dtype == want.dtype
            if got.dtype == np.int8:
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
