"""The port's LM trainer against the reference's (``repro.train``), on the
reference's own initial state (``params_from_numpy``) and the SMOKE
configs in fp32, with the same numpy tokens.

Bars: one step of each ported architecture (AdamW as the SMOKE configs
set it, and Adafactor for a dense and a MoE config): the loss, ``ce``
and ``aux`` within 1e-5 relative, each leaf's gradient within 1e-5 of
the leaf's max |g|, the updated params within 1e-5 absolute; a 10-step
loss trajectory within 1e-4 relative; the stacked DIGEST pod form (2
pods, interval 4) 8 steps of loss and ``pod_divergence`` within 1e-4
relative, the divergence exactly 0 after each sync.  Matrix products of
another library and sums in another order differ by ~1e-7.  Port against
port, bit for bit: ``remat`` on against off, resume (train 5 against 3,
save, restore, 2), a checkpoint round trip, and the pod form over gloo
ranks against the stacked form (``tests/test_torch_mesh.py``).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import checkpoint as jckpt
from repro import train as jtrain
from repro.configs import get_smoke_arch as jget
from repro.train import trainer as jtrainer
from repro_torch import checkpoint as tckpt
from repro_torch import train as ttrain
from repro_torch.checkpoint.checkpoint import _paths
from repro_torch.configs import PORTED
from repro_torch.configs import get_smoke_arch as tget
from repro_torch.launch import train as tlaunch
from repro_torch.nn import params_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.train import trainer as ttrainer

REL = 1e-5
TRAJ = 1e-4
# The trainer's FSDP over "data" = 2 at the SMOKE widths, a step: the
# gathers of the forward and its recomputation (the aux loss's embedding
# table too), and one reduce-scatter (``all_to_all``) a leaf cut over
# "data".
FSDP = {"qwen3-0.6b": (40, 21), "llama4-scout-17b-a16e": (53, 28)}
# Adafactor: a dense and a MoE config, and the two new families whose
# published optimizer it is.
ADAFACTOR = ("deepseek_coder_33b", "kimi_k2_1t_a32b", "recurrentgemma_9b",
             "llama_3_2_vision_11b")
XATTN_GATE = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    """The SMOKE models' ops are small: one intra-op thread runs them
    about as fast alone, and far faster beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(name, **over):
    return (dataclasses.replace(jget(name), **over),
            dataclasses.replace(tget(name), **over))


def _settings(**kw):
    base = dict(total_steps=100, warmup_steps=5)
    base.update(kw)
    return jtrain.TrainSettings(**base), ttrain.TrainSettings(**base)


def _to_port(jstate):
    """The reference's train state as the port's tensors (CPU)."""
    host = jax.tree.map(np.asarray, {"params": jstate["params"],
                                     "opt_state": jstate["opt_state"]})
    return {"params": params_from_numpy(host["params"], "cpu"),
            "opt_state": params_from_numpy(host["opt_state"], "cpu"),
            "step": torch.tensor(int(jstate["step"]), dtype=torch.int32)}


def _batches(vocab, n, batch=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, vocab, (batch, seq + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "labels": toks[:, 1:],
                    "mask": np.ones((batch, seq), np.float32)})
    return out


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def _jit_step(jcfg, jset):
    return jax.jit(jtrain.make_train_step(jcfg, jset))


def _keyed(tree) -> dict:
    """The reference tree's leaves by the checkpoint's key."""
    return {"/".join(jckpt.checkpoint._fmt(p) for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# API
# ---------------------------------------------------------------------------

def test_exports_match_reference():
    assert ttrain.__all__ == jtrain.__all__


def test_train_settings_match_reference():
    jf = dataclasses.fields(jtrain.TrainSettings)
    tf = dataclasses.fields(ttrain.TrainSettings)
    assert [f.name for f in tf] == [f.name for f in jf]
    assert [f.default for f in tf] == [f.default for f in jf]


@pytest.mark.parametrize("name,over", [("qwen3_0_6b", {}),
                                       ("kimi_k2_1t_a32b",
                                        {"optimizer": "adafactor"})])
@pytest.mark.parametrize("n_pod", [1, 2])
def test_state_trees_match_reference(name, over, n_pod):
    """``init_train_state`` and ``abstract_train_state``: every leaf's key,
    shape and dtype, with and without the stacked pod dim."""
    jcfg, tcfg = _configs(name, **over)
    jset, tset = _settings(sync_mode="digest", n_pod=n_pod)
    want = {k: (tuple(v.shape), np.dtype(v.dtype).name)
            for k, v in _keyed(jtrain.abstract_train_state(jcfg, jset)
                               ).items()}
    for state, device in ((ttrain.init_train_state(tcfg, tset,
                                                   device="cpu"), "cpu"),
                          (ttrain.abstract_train_state(tcfg, tset), "meta")):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _paths(state)}
        assert got == want
        assert state["step"].dtype == torch.int32
        assert state["step"].device.type == "cpu"
        assert all(v.device.type == device
                   for k, v in _paths(state) if k != "step")


# ---------------------------------------------------------------------------
# One step, trajectories, the stacked pod form
# ---------------------------------------------------------------------------

def _open_gates(jstate):
    """The reference's state with every ``xattn`` gate at XATTN_GATE (zero
    at init, where the cross-attention adds nothing)."""
    params = jax.tree.map(np.array, jstate["params"])
    for block in [*params["pattern"], *params["tail"]]:
        if "gate" in block:
            block["gate"][...] = XATTN_GATE
    return dict(jstate, params=jax.tree.map(jnp.asarray, params))


@pytest.mark.parametrize("name,optimizer", [
    *((n, None) for n in PORTED), *((n, "adafactor") for n in ADAFACTOR)])
def test_one_step_matches_reference(name, optimizer):
    """Every architecture; the VLM's batch carries a (B, num_patches,
    vision_dim) vision input and its gates are open."""
    over = {"optimizer": optimizer} if optimizer else {}
    jcfg, tcfg = _configs(name, **over)
    jset, tset = _settings()
    jstate = _open_gates(jtrain.init_train_state(jcfg, jset))
    tstate = _to_port(jstate)
    b = _batches(jcfg.vocab_size, 1, batch=2, seq=16, seed=1)[0]
    if jcfg.vision_dim:
        b["vision"] = np.random.default_rng(2).normal(
            size=(2, jcfg.num_patches, jcfg.vision_dim)).astype(np.float32)

    def both(state, batch):
        grad = jax.value_and_grad(
            lambda p: jtrainer._loss_fn(jcfg, jset, p, batch), has_aux=True)
        return grad(state["params"]), jtrain.make_train_step(jcfg, jset)(
            state, batch)

    ((jl, jparts), jg), (jnew, jm) = jax.jit(both)(jstate, _jb(b))
    tl, tparts, tg = ttrainer.loss_and_grads(tcfg, tset, tstate["params"],
                                             _tb(b))
    tnew, tm = ttrain.make_train_step(tcfg, tset)(tstate, _tb(b))
    assert _rel(float(tl), float(jl)) < REL
    for k in ("ce", "aux"):
        assert abs(float(tparts[k]) - float(jparts[k])) <= REL * max(
            abs(float(jparts[k])), 1e-30), k
        assert float(tm[k]) == float(tparts[k])
    assert float(tm["loss"]) == float(tl)
    for (key, want), got in zip(_keyed(jg).items(), tree_leaves(tg)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max()
        assert err <= REL * max(np.abs(want).max(), 1e-30), key
    for (key, want), got in zip(_keyed(jnew["params"]).items(),
                                tree_leaves(tnew["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=REL, err_msg=key)
    assert int(tnew["step"]) == 1 and tnew["step"].dtype == torch.int32


def test_trajectory_matches_reference():
    """qwen3-0.6b SMOKE, 10 steps of the launcher's pipeline (the same
    tokens in both packages), AdamW under the warmup-cosine schedule."""
    from repro.data import make_lm_pipeline as jpipe
    from repro_torch.data import make_lm_pipeline as tpipe
    jcfg, tcfg = _configs("qwen3_0_6b")
    jset, tset = _settings(total_steps=10, warmup_steps=2)
    jstate = jtrain.init_train_state(jcfg, jset)
    tstate = _to_port(jstate)
    jstep, tstep = _jit_step(jcfg, jset), ttrain.make_train_step(tcfg, tset)
    ji = jpipe(jcfg.vocab_size, 4, 16, seed=2)
    ti = tpipe(tcfg.vocab_size, 4, 16, seed=2, device="cpu")
    jl, tl = [], []
    for _ in range(10):
        a, b = next(ji), next(ti)
        jstate, jm = jstep(jstate, {"tokens": a.tokens, "labels": a.labels,
                                    "mask": a.mask})
        tstate, tm = tstep(tstate, {"tokens": b.tokens, "labels": b.labels,
                                    "mask": b.mask})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert _rel(tl, jl) < TRAJ
    assert tl[-1] < tl[0]


def test_digest_stacked_pods_match_reference():
    """n_pod = 2, interval 4, 8 steps: the reference's pod-sync test,
    held step by step against the reference."""
    jcfg, tcfg = _configs("qwen3_0_6b", vocab_size=64)
    jset, tset = _settings(sync_mode="digest", n_pod=2, sync_interval=4,
                           total_steps=40, warmup_steps=2)
    jstate = jtrain.init_train_state(jcfg, jset)
    tstate = _to_port(jstate)
    assert tree_leaves(tstate["params"])[0].shape[0] == 2
    jstep, tstep = _jit_step(jcfg, jset), ttrain.make_train_step(tcfg, tset)
    jm_all, tm_all = [], []
    for b in _batches(64, 8, batch=8, seq=16, seed=3):
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        jm_all.append({k: float(v) for k, v in jm.items()})
        tm_all.append({k: float(v) for k, v in tm.items()})
    for k in ("loss", "ce", "pod_divergence"):
        assert _rel([m[k] for m in tm_all], [m[k] for m in jm_all]) < TRAJ
    div = [m["pod_divergence"] for m in tm_all]
    assert div[3] == 0.0 and div[7] == 0.0
    assert div[1] > 0.0 and div[5] > 0.0
    for x in tree_leaves(tstate["params"]):
        assert torch.equal(x[0], x[1])


def test_every_step_mode_has_no_pod_dim():
    _, tcfg = _configs("qwen3_0_6b")
    state = ttrain.init_train_state(
        tcfg, ttrain.TrainSettings(sync_mode="every_step", n_pod=2),
        device="cpu")
    assert tree_leaves(state["params"])[0].shape == (
        tcfg.vocab_size, tcfg.d_model)


def _run(cfg, settings, batches, state=None):
    state = state or ttrain.init_train_state(cfg, settings, device="cpu")
    step = ttrain.make_train_step(cfg, settings)
    metrics = []
    for b in batches:
        state, m = step(state, _tb(b))
        metrics.append(m)
    return state, metrics


def _equal(a, b) -> bool:
    la, lb = _paths(a), _paths(b)
    return [k for k, _ in la] == [k for k, _ in lb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(la, lb))


@pytest.mark.parametrize("name", ["qwen3_0_6b", "llama4_scout_17b_a16e"])
def test_remat_changes_no_bit(name):
    _, tcfg = _configs(name)
    _, tset = _settings()
    batches = _batches(tcfg.vocab_size, 2, batch=2, seq=16, seed=4)
    on = _run(dataclasses.replace(tcfg, remat=True), tset, batches)
    off = _run(dataclasses.replace(tcfg, remat=False), tset, batches)
    assert _equal(on[0], off[0])
    assert _equal(on[1], off[1])


def test_kernel_backend_refuses_grad():
    """K6 has no backward (nor has the reference's): a training step
    through it raises, inside remat's checkpoint too."""
    _, tcfg = _configs("qwen3_0_6b")
    _, tset = _settings()
    b = _batches(tcfg.vocab_size, 1, batch=2, seq=16)
    for remat in (True, False):
        cfg = dataclasses.replace(tcfg, attn_backend="kernel", remat=remat)
        with pytest.raises(RuntimeError, match="no backward"):
            _run(cfg, tset, b)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def test_train_state_checkpoint_roundtrip(tmp_path):
    """Adafactor's {"row", "col"} / {"v"} leaves and the 0-d int32 step
    come back as they went, bit for bit."""
    _, tcfg = _configs("kimi_k2_1t_a32b", optimizer="adafactor")
    _, tset = _settings()
    state, _ = _run(tcfg, tset, _batches(tcfg.vocab_size, 3, batch=2))
    tckpt.save_checkpoint(str(tmp_path), int(state["step"]), state)
    template = ttrain.init_train_state(tcfg, tset, seed=5, device="cpu")
    restored, step = tckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 3
    assert _equal(restored, state)
    assert restored["step"].shape == () and int(restored["step"]) == 3


@pytest.mark.parametrize("name", ["qwen3_0_6b", "musicgen_large"])
def test_resume_is_bitwise(tmp_path, name):
    """train(5) == train(3) -> checkpoint -> restore -> train(2)."""
    _, tcfg = _configs(name)
    _, tset = _settings(total_steps=20, warmup_steps=2)
    batches = _batches(tcfg.vocab_size, 5)
    whole, _ = _run(tcfg, tset, batches)
    part, _ = _run(tcfg, tset, batches[:3])
    tckpt.save_checkpoint(str(tmp_path), 3, part)
    template = ttrain.init_train_state(tcfg, tset, seed=9, device="cpu")
    part, step = tckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 3
    resumed, _ = _run(tcfg, tset, batches[3:], state=part)
    assert _equal(resumed, whole)


def test_reference_checkpoint_restores_and_trains(tmp_path):
    """The reference's train state after 3 steps, saved by the reference,
    restores in the port exactly; 2 more steps in each package stay
    within the bars."""
    jcfg, tcfg = _configs("qwen3_0_6b", optimizer="adafactor")
    jset, tset = _settings(total_steps=20, warmup_steps=2)
    batches = _batches(jcfg.vocab_size, 5, seed=6)
    jstep = _jit_step(jcfg, jset)
    jstate = jtrain.init_train_state(jcfg, jset)
    for b in batches[:3]:
        jstate, _ = jstep(jstate, _jb(b))
    jckpt.save_checkpoint(str(tmp_path), 3, jstate)
    template = ttrain.init_train_state(tcfg, tset, device="cpu")
    tstate, step = tckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 3 and int(tstate["step"]) == 3
    for (key, want), (tkey, got) in zip(_keyed(jstate).items(),
                                        _paths(tstate)):
        assert key == tkey
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    tstep = ttrain.make_train_step(tcfg, tset)
    jl, tl = [], []
    for b in batches[3:]:
        jstate, jm = jstep(jstate, _jb(b))
        tstate, tm = tstep(tstate, _tb(b))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    assert _rel(tl, jl) < TRAJ
    for (key, want), got in zip(_keyed(jstate["params"]).items(),
                                tree_leaves(tstate["params"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=REL, err_msg=key)


# ---------------------------------------------------------------------------
# The pod form over gloo ranks
# ---------------------------------------------------------------------------

def test_pod_form_refuses_without_a_pod_mesh():
    _, tcfg = _configs("qwen3_0_6b")
    _, tset = _settings(sync_mode="digest", n_pod=2, pod_impl="shard_map")
    with pytest.raises(ValueError, match="needs a mesh with a 'pod' axis"):
        ttrain.make_train_step(tcfg, tset)


_REF_POD_DATA = r"""
import dataclasses, sys
import jax, numpy as np
from repro import train
from repro.configs import get_smoke_arch
from repro.distributed.sharding import axis_rules
from repro.launch.mesh import make_host_mesh
assert jax.device_count() >= 4, jax.device_count()
steps, interval = int(sys.argv[2]), int(sys.argv[3])
cfg = dataclasses.replace(get_smoke_arch("qwen3_0_6b"), vocab_size=64)
s = train.TrainSettings(sync_mode="digest", n_pod=2, pod_impl="shard_map",
                        sync_interval=interval, total_steps=40,
                        warmup_steps=2)
state = train.init_train_state(cfg, s)
out = {f"init{i}": np.asarray(x)
       for i, x in enumerate(jax.tree.leaves(state["params"]))}
rng = np.random.default_rng(4)
mesh = make_host_mesh(data=2, model=1, pod=2)
with axis_rules(mesh):
    step = jax.jit(train.make_train_step(cfg, s))
    for i in range(steps):
        toks = rng.integers(0, 64, (4, 17)).astype(np.int32)
        mask = (rng.random((4, 16)) < 0.7).astype(np.float32)
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        out.update({f"{k}{i}": v for k, v in b.items()})
        state, m = step(state, b)
        out.update({f"{k}{i}/metric": np.asarray(v) for k, v in m.items()})
for i, x in enumerate(jax.tree.leaves(state["params"])):
    out[f"final{i}"] = np.asarray(x)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def pod_world4():
    import test_torch_mesh as tm
    return tm.spawn("lm_pod_job", 4, steps=8, interval=4)


@pytest.mark.parametrize("world", [2, 4])
def test_pod_form_equals_stacked_form(world, request):
    """One gloo rank a pod (``pod_impl="shard_map"``) against the stacked
    form computed in each rank: 8 steps at interval 4, metrics, this
    pod's params and optimizer state bit for bit every step.  Census:
    one ``all_gather`` of (loss, ce, aux) a step, and one of the
    flattened params at a sync step.  Refused (ValueError): no mesh and a
    ("data",) mesh (the reference's text), a mesh for the stacked form.
    At world 4 the (pod 2, data 2) form, FSDP inside each pod (the
    trainer's rules), against the stacked form (qwen3-0.6b and
    llama4-scout SMOKE): the step-1 gradient and this pod's whole params
    after step 1 within 1e-5 of a leaf's max, each step's loss, ce and
    aux within 1e-4 (Adam's steps carry the sums' rounding on, so later
    params are held through the trajectory); census a step (:data:`FSDP`):
    the mask count's ``all_reduce``, the FSDP gathers and reduce-scatters,
    the gradients' ``all_gather`` over "data" (and the aux loss's
    dispatch counts), the pod mean's."""
    import test_torch_mesh as tm
    ranks = (request.getfixturevalue("pod_world4") if world == 4
             else tm.spawn("lm_pod_job", world, steps=8, interval=4))
    assert sorted(r["pod"] for r in ranks) == list(range(world))
    for r in ranks:
        assert all(r["equal"]), r["equal"]
        assert r["census"] == [{"all_gather": 2 if (s + 1) % 4 == 0 else 1}
                               for s in range(8)]
        assert r["divergence"][3] == 0.0 and r["divergence"][7] == 0.0
        assert r["divergence"][1] > 0.0
        assert "needs a mesh with a 'pod' axis" in r["refusals"]["none"]
        assert "needs a mesh with a 'pod' axis" in r["refusals"][
            "data only"]
        assert "takes no mesh" in r["refusals"]["stacked form"]
    if world == 2:
        return
    for arch, aux in (("qwen3-0.6b", 0), ("llama4-scout-17b-a16e", 1)):
        res = [r[f"data2 {arch}"] for r in ranks]
        gathers, scatters = FSDP[arch]
        for r in res:
            assert r["grad_err"] <= REL, arch
            assert max(r["loss_rel"]) <= TRAJ, (arch, r["loss_rel"])
            assert r["params_err"][0] <= REL, (arch, r["params_err"])
            assert r["census"] == [
                {"all_reduce": 1, "all_to_all": scatters,
                 "all_gather": gathers + 2 + aux + ((s + 1) % 4 == 0)}
                for s in range(8)], (arch, r["census"])
        # The two data ranks of a pod gather the same whole params.
        pods = [r["data2 pod"] for r in ranks]
        for p in (0, 1):
            a, b = (res[i]["params"] for i in range(4) if pods[i] == p)
            assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_pod_data_form_matches_reference(tmp_path):
    """The port's (pod 2, data 2) form on 4 gloo ranks (FSDP inside each
    pod, the trainer's rules) against the
    reference's ``_make_pod_shard_map_step`` on the same mesh (a forced
    4-device JAX subprocess), from the reference's initial params, under
    a mask of uneven counts: 4 steps at interval 2, each step's loss, ce
    and aux within 1e-4, the params after the last (a sync) step within
    1e-5 absolute (between syncs the reference returns one pod's copy),
    every rank's the same bits."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    import test_torch_mesh as tm
    ref = str(tmp_path / "ref.npz")
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", _REF_POD_DATA, ref, "4",
                          "2"], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    want = np.load(ref)
    ranks = tm.spawn("lm_reference_job", 4, ref_npz=ref, interval=2)
    for r in ranks:
        for i, m in enumerate(r["metrics"]):
            for k in ("loss", "ce", "aux"):
                w = float(want[f"{k}{i}/metric"])
                assert abs(m[k] - w) <= TRAJ * max(abs(w), 1e-30), (i, k)
        for i, got in enumerate(r["params"]):
            np.testing.assert_allclose(got, want[f"final{i}"], rtol=0,
                                       atol=REL, err_msg=str(i))
        assert all(np.array_equal(x, y)
                   for x, y in zip(r["params"], ranks[0]["params"]))


def _every_step_against_one_process(ranks, axes: int) -> None:
    """:func:`test_data_parallel_every_step_equals_one_process`'s bars
    over a mesh of ``axes`` batch dimensions."""
    for arch, aux in (("qwen3-0.6b", 0), ("llama4-scout-17b-a16e", 1)):
        gathers, scatters = FSDP[arch]
        for r in ranks:
            res = r[arch]
            assert res["grad_err"] <= REL, arch
            assert res["params_err"][0] <= REL, (arch, res["params_err"])
            assert max(res["loss_rel"]) <= TRAJ, (arch, res["loss_rel"])
            assert res["census"] == [
                {"all_reduce": axes, "all_to_all": scatters,
                 "all_gather": gathers + axes * (1 + aux)}] * 4
        assert all(np.array_equal(x, y) for r in ranks[1:] for x, y in
                   zip(ranks[0][arch]["params"], r[arch]["params"]))
    for r in ranks:
        assert r["data 1 is single"]


def test_data_parallel_every_step_equals_one_process():
    """The ``every_step`` baseline on a ("data",) = 2 mesh (each rank two
    of the batch's four rows) under the trainer's rules (FSDP over
    "data") against the single process, 4 steps, with rank 0's rows
    masked more than rank 1's: qwen3-0.6b and llama4-scout SMOKE (whose
    aux loss multiplies two token means: the ranks gather the dispatch
    counts before the product).  The step-1 gradient within 1e-5 of a
    leaf's max, the whole params after step 1 too, each step's loss, ce
    and aux within 1e-4; the two ranks gather the same whole params;
    census a step (:data:`FSDP`): the mask count's ``all_reduce``, the
    FSDP gathers and reduce-scatters, the gradients' (and aux counts')
    ``all_gather``.  A mesh with no batch dimension above 1 is the
    single-device step bit for bit."""
    import test_torch_mesh as tm
    _every_step_against_one_process(tm.spawn("lm_dp_job", 2, steps=4), 1)


def test_data_parallel_every_step_over_pod_and_data_equals_one_process():
    """The same over ("pod", "data") = 2 x 2, the batch split over both
    and each FSDP block held in both pods: a leaf cut over "data" has its
    gradient reduce-scattered over "data", then added over "pod", so the
    two pods step their blocks on the whole batch's gradient and gather
    the same whole params; census a step: one ``all_reduce`` and one
    gradient ``all_gather`` (and one of the aux counts) a batch
    dimension."""
    import test_torch_mesh as tm
    _every_step_against_one_process(tm.spawn("lm_dp_job", 4, steps=4), 2)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = tlaunch.main(["--device", "cpu", "--smoke", "--arch",
                        "qwen3-0.6b", "--steps", "4", "--log-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 4 and np.all(np.isfinite(out["losses"]))
    assert len(out["step_s"]) == 4
    text = capsys.readouterr().out
    assert "arch=qwen3-0.6b" in text and "step     4 loss=" in text
    assert tckpt.latest_step(str(tmp_path)) == 4
    out = tlaunch.main(["--device", "cpu", "--smoke", "--arch",
                        "qwen3-0.6b", "--steps", "2", "--log-every", "2",
                        "--ckpt-dir", str(tmp_path)])
    assert "resumed from step 4" in capsys.readouterr().out
    assert int(out["state"]["step"]) == 6


def test_train_launcher_refuses_a_missing_card_and_the_tpu_mesh(capsys):
    # The production mesh is a torchrun job's: without --dist-backend the
    # launcher refuses it (its world-size check: test_torch_dryrun.py).
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--smoke", "--arch", "qwen3-0.6b",
                      "--production-mesh"])
    assert "--production-mesh needs --dist-backend" in capsys.readouterr().err
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlaunch.main(["--smoke", "--arch", "qwen3-0.6b", "--steps", "1"])


def test_take_rows_backward_is_ordered_on_the_cpu():
    """The embedding's and the MoE's gathers: autograd's own backward of
    an index is a parallel accumulation on the CPU whose bits change run
    to run once a gradient is split among threads; ``take_rows`` adds
    the rows in index order (the same bits every run) and equals the
    float64 sum within float32 rounding (rtol 1e-5)."""
    from repro_torch.nn import take_rows
    torch.set_num_threads(4)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 512, (8, 512), generator=g)
    up = torch.randn(8, 512, 128, generator=g)
    table = torch.randn(512, 128, generator=g)

    def grad():
        t = table.clone().requires_grad_(True)
        return torch.autograd.grad((take_rows(t, ids) * up).sum(), t)[0]

    first = grad()
    assert all(torch.equal(first, grad()) for _ in range(10))
    want = torch.zeros(512, 128, dtype=torch.float64).index_add_(
        0, ids.reshape(-1), up.reshape(-1, 128).double())
    np.testing.assert_allclose(first.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    with torch.no_grad():
        assert torch.equal(take_rows(table, ids), table[ids])
