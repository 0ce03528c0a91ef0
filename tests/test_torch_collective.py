"""The port's mesh paths (``pull_mode="collective"``) in gloo ranks on
the CPU, against the port's single-process paths and the reference.

The ranks (``tests/test_torch_mesh.py``, one ``torch.multiprocessing`` spawn
a group of checks) hold the port against itself bit for bit:

* ``collective_pull`` == ``pull_slab``, ``shard_push(_ef)`` ==
  ``push(_ef)`` (store and residual) and ``shard_staleness_error`` ==
  ``staleness_error`` for fp32, bf16 and int8 stores at k = 1 and 2 parts
  a rank, on a ("data",) mesh of 4 ranks and a ("pod", "data") = 2 x 2
  mesh (flickr-sim 0.12, M = 4 and 8, 2 layers of width 8), and 2 GCN
  int8 epochs on the pod mesh equal to the single-process run;
* the k = 1 pull (M = 4, W = 4) of the reference's pushed fp32 and int8
  stores equal to the reference's own ``collective_pull`` in a forced
  4-device JAX subprocess (as ``tests/hlo_utils.py`` runs one);
* a collective epoch equal to the single-process epoch under
  ``torch.equal`` (metrics every epoch, the whole gathered state at the
  end) for 6 epochs on 2 ranks (k = 2 of M = 4; flickr-sim 0.15, 3
  layers of width 16, interval 2): GCN fp32, GCN int8, projected GAT
  int8, 4 sampled GCN steps, the partition baseline with the LLCG
  correction, the propagation baseline over bf16, and ``digest_train``
  with the ema predictor, drop faults and the watchdog (error feedback:
  ``tests/test_torch_checkpoint.py``'s sharded run).

The collective runs are then held to the reference's gather runs at the
training parity bars (``tests/test_torch_train.py``): the loss, train F1
and staleness trajectories within 1e-4, epoch-1 gradients within 1e-5 of
each leaf's max |g|, the final store's fp32 rows within 1e-5, int8 codes
equal and scales within 1e-6 relative (the reference's jitted int8 scale
is not always the correctly rounded quotient).  The LLCG and propagation
runs are held port against port only (LLCG draws its server batch from
``torch.Generator``, not ``jax.random``).

The census (``core.collectives.COLLECTIVES``), derived from the code: a
pull ships each store tensor once, so one ``all_to_all`` a tensor
(fp32/bf16 1, int8 data + scale 2; GAT one a projected z tensor a hidden
layer, here 2 x 2), plus on the 2-pod mesh one ``send`` and one ``recv``
a tensor (pods - 1 = 1 peer); an epoch adds one ``all_reduce`` of the
(M, params + 3) gradient, loss and F1-count buffer and one of the
staleness eps and push age (MAX), so every epoch has 2 all-reduces, a
pull epoch (r even) its all-to-alls and no other epoch any; nothing is
ever all-gathered or broadcast inside an epoch.
"""
import functools
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

import test_torch_mesh as tm
from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import faults as jfaults
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import build_sampler as jbuild_sampler
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro.nn import init_params

ROOT = Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-5
TRAJ_TOL = 1e-4

# The reference's pushes and collective pulls at M = 4 on 4 forced CPU
# devices, the inputs of exchange_job's cross-package check.
_REF_PULL = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import halo_exchange as hx
from repro.graph import build_partitions, make_dataset
from repro.launch.mesh import make_host_mesh
assert jax.device_count() >= 4, jax.device_count()
g = make_dataset("flickr-sim", scale=0.12, seed=5)
sp = build_partitions(g, 4)
reps = np.random.default_rng(0).normal(
    size=(4, 2, sp.part_size, 8)).astype(np.float32)
plan = sp.pull_plan()
mesh = make_host_mesh(data=4)
out = {}
for storage in ("fp32", "int8"):
    store = hx.init_store(2, sp.store_rows - 1, 8, hx.HaloPrecision(storage))
    store = hx.push(store, jnp.asarray(sp.local_slots),
                    jnp.asarray(sp.local_valid), jnp.asarray(reps),
                    jnp.asarray(sp.sentinel_slots))
    slab = hx.collective_pull(store, jnp.asarray(plan.send_offsets),
                              jnp.asarray(plan.recv_positions),
                              sp.halo_size, mesh)
    for k in store:
        out[f"{storage}/store/{k}"] = np.asarray(store[k])
        out[f"{storage}/slab/{k}"] = np.asarray(slab[k])
np.savez(sys.argv[1], **out)
"""


def _reference_pull(path: str) -> None:
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _REF_PULL, path], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture(scope="module")
def exchange(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "pull.npz")
    _reference_pull(path)
    return tm.spawn("exchange_job", 4, ref_npz=path)


@pytest.mark.parametrize("num_parts", [4, 8])
@pytest.mark.parametrize("mesh", ["data", "pod"])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_collective_pull_census(exchange, num_parts, mesh, storage):
    """The ranks checked the pull, push, EF push and eps bit for bit
    (and the reference's pull at M = 4 on the data mesh); every rank's
    pull made one all-to-all a store tensor and, on pods, one send and
    one receive a tensor, and nothing else."""
    tensors = 2 if storage == "int8" else 1
    want = {"all_to_all": tensors}
    if mesh == "pod":
        want.update(send=tensors, recv=tensors)
    for rank in exchange:
        assert rank["census"][(num_parts, mesh, storage)] == want


def test_geometry_error_for_m6_on_four_ranks(exchange):
    for rank in exchange:
        msg = rank["geometry_error"]
        assert "num_parts=6" in msg and "4 devices" in msg


def _capture(base):
    def init(p):
        return {"opt": base.init(p), "grads": p}

    def update(g, s, p, step):
        new_p, new_s = base.update(g, s["opt"], p, step)
        return new_p, {"opt": new_s, "grads": g}

    return joptim.Optimizer("capture", init, update)


@functools.lru_cache(maxsize=None)
def _jgraph():
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return g, jdigest.prepare_graph_data(g, tm.PARTS, seed=0)


def _jcfg(model):
    g, _ = _jgraph()
    return jgnn.GNNConfig(model=model, num_layers=3,
                          in_dim=g.features.shape[1], hidden_dim=16,
                          num_classes=int(g.labels.max()) + 1, heads=2)


@functools.lru_cache(maxsize=None)
def _jparams(model):
    return init_params(jax.random.PRNGKey(0), jgnn.gnn_specs(_jcfg(model)))


def _jsettings(storage="fp32", ef=False, predictor="none", **kw):
    return jdigest.TrainSettings(
        sync_interval=2, precision=jhx.HaloPrecision(storage, ef),
        predictor=jpred.PredictorConfig(predictor), **kw)


@pytest.fixture(scope="module")
def training():
    params = {m: jax.tree.map(np.asarray, _jparams(m))
              for m in ("gcn", "gat")}
    ranks = tm.spawn("train_job", 2, params=params)
    # Every rank holds the same mesh-wide results.
    for other in ranks[1:]:
        for name in tm.RUNS:
            assert other[name]["census"] == ranks[0][name]["census"]
    return ranks[0]


def _reference_run(name):
    """The reference's gather run of ``tm.RUNS[name]``: per-epoch (loss,
    train F1, eps), epoch-1 gradients and the final store."""
    model, skw, sampled = tm.RUNS[name]
    _, jdata = _jgraph()
    cfg, jp = _jcfg(model), _jparams(model)
    settings = _jsettings(**skw)
    opt = _capture(joptim.adam(tm.LR))
    tdata = {k: v for k, v in jdata.items() if not k.startswith("_")}
    if sampled:
        state = jdigest.init_sampled_state(cfg, opt, jdata,
                                           precision=settings.precision)
        fn = jax.jit(jdigest.make_sampled_epoch_fn(cfg, opt, settings))
        sampler = jbuild_sampler(jdata, tm.FANOUT, tm.SEEDS, seed=0)

        def step(st, t):
            batch = jax.tree.map(jax.numpy.asarray, sampler.sample(t))
            return fn(st, tdata, batch)
        rounds = tm.SAMPLED_STEPS
    else:
        state = jdigest.init_state(cfg, opt, jdata,
                                   precision=settings.precision)
        fn = jax.jit(jdigest.make_epoch_fn(cfg, opt, settings))

        def step(st, _):
            return fn(st, tdata)
        rounds = tm.EPOCHS
    state["params"], state["opt_state"] = jp, opt.init(jp)
    traj, grads = [], None
    for t in range(rounds):
        state, m = step(state, t)
        traj.append((float(m["loss"]), float(m["train_f1"]),
                     np.asarray(m["staleness_eps"])))
        if t == 0:
            grads = [np.asarray(g) for g in
                     jax.tree.leaves(state["opt_state"]["grads"])]
    return traj, grads, jax.tree.map(np.asarray, state["store"])


def _hold_store(got, want):
    if "scale" in want:
        np.testing.assert_array_equal(got["data"], want["data"])
        np.testing.assert_allclose(got["scale"], want["scale"], rtol=1e-6,
                                   atol=0)
    else:
        np.testing.assert_allclose(got["data"],
                                   want["data"].astype(np.float32),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", ["gcn_fp32", "gcn_int8", "gat_int8",
                                  "gcn_sampled"])
def test_collective_training_matches_reference(training, name):
    """The ranks held the run equal to the port's single-process run; here
    it is held to the reference's gather run at the parity bars."""
    got = training[name]
    traj, grads, store = _reference_run(name)
    for (jl, jf, je), (tl, tf, te) in zip(traj, got["traj"]):
        assert np.isfinite(tl)
        assert abs(jl - tl) <= TRAJ_TOL and abs(jf - tf) <= TRAJ_TOL
        np.testing.assert_allclose(te, je, rtol=0, atol=TRAJ_TOL)
    assert len(grads) == len(got["grads"])
    for a, b in zip(grads, got["grads"]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=GRAD_TOL * max(np.abs(a).max(),
                                                       1e-30))
    _hold_store(got["store"], store)


@pytest.mark.parametrize("name", list(tm.RUNS))
def test_collective_epoch_census(training, name):
    """Each epoch: 2 all-reduces; a pull epoch (r even) one all-to-all a
    store tensor (GAT: a z tensor a hidden layer); no all-gather or
    broadcast; the partition and propagation baselines pull nothing."""
    model, skw, _ = tm.RUNS[name]
    tensors = 2 if skw.get("storage") == "int8" else 1
    if model == "gat":
        tensors *= 2                       # z0, z1
    digest_mode = skw.get("mode", "digest") == "digest"
    for t, census in enumerate(training[name]["census"]):
        want = {"all_reduce": 2}
        if digest_mode and (t + 1) % 2 == 0:
            want["all_to_all"] = tensors
        assert census == want, (t + 1, census)


def test_digest_train_faults_predictor_match_reference(training):
    """``digest_train`` over the mesh with the ema predictor, drop faults
    and watchdog 3 (equal to the single-process run in the ranks) against
    the reference's ``digest_train``: the per-epoch history within 1e-4,
    the push ages equal, the final store within 1e-5."""
    got = training["gcn_ema_faults"]
    _, jdata = _jgraph()
    settings = _jsettings(predictor="ema", max_staleness=tm.MAX_STALENESS)
    state, hist = jdigest.digest_train(
        _jcfg("gcn"), joptim.adam(tm.LR), jdata, settings, tm.EPOCHS,
        eval_every=1, faults=jfaults.FaultConfig(**tm.FAULTS))
    thist = got["hist"]
    assert thist["epoch"] == hist["epoch"]
    assert thist["push_age"] == hist["push_age"]
    for key in ("loss", "train_f1", "val_f1", "test_f1"):
        np.testing.assert_allclose(thist[key], hist[key], rtol=0,
                                   atol=TRAJ_TOL)
    np.testing.assert_allclose(thist["staleness_eps"],
                               hist["staleness_eps"], rtol=0, atol=TRAJ_TOL)
    _hold_store(got["store"], jax.tree.map(np.asarray, state["store"]))


@pytest.mark.parametrize("launcher,args,expect", [
    ("train_gnn", ["--pull", "collective", "--data-axis", "2",
                   "--parts", "4", "--epochs", "2", "--interval", "2"],
     "collective mode: 2 subgraph(s)/owner shard(s) per device over mesh "
     "{'data': 2}"),
    ("serve_gnn", ["--sharded", "--batches", "6"], "sharded[2 ranks]"),
])
def test_launcher_under_torchrun(launcher, args, expect):
    """``torchrun --nproc-per-node 2`` of the launcher on the CPU over
    gloo at a small scale finishes, rank 0 printing the mesh."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", f"repro_torch.launch.{launcher}",
           "--device", "cpu", "--dist-backend", "gloo", "--scale", "0.1",
           *args]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert expect in res.stdout, res.stdout
    assert res.stdout.count(expect) == 1
