"""The LM trainer's tensor parallelism and FSDP (``make_train_step`` over a
mesh's "model" dimension, under the reference trainer's rules
``{"embed": "data"}``) against the reference's single-device
``make_train_step``.

* Four gloo ranks (``tests/test_torch_mesh.py::tp_train_job``, one
  intra-op thread each) train a SMOKE config of each block kind —
  qwen3-0.6b (AdamW), deepseek-coder-33b (Adafactor), llama4-scout
  (MoE), recurrentgemma-9b, xlstm-1.3b and the VLM — for 4 steps over
  ("replica", "model") = 2 x 2 (two 1 x 2 meshes side by side) and
  ("data", "model") = 2 x 2 (FSDP), from parameters drawn with numpy
  from a seed; JAX subprocesses run the reference on one device beside
  them.  Bars: the step-1 loss within 1e-6, each leaf of the step-1
  gradient (gathered whole) within 1e-5 of the leaf's max |g|, the 4
  losses (and ``ce``, ``aux``) within 1e-4; every rank holds the same
  bits of the whole params (data replicas and "model" groups alike);
  the census.
* The vocab-parallel NLL, the global norm and Adafactor on cut leaves
  against the whole leaf's; a kill and resume across meshes (mesh → one
  process → mesh) bit for bit.
* Eight gloo ranks run the digest ``shard_map`` form at interval 5 over
  (pod 2, data 2, model 2), qwen3-0.6b SMOKE at 4 heads / 2 KV heads (the
  reference's ``tests/test_sharding.py`` lowering, run), against the
  reference's stacked form: each step's loss, ce and aux within 1e-4.
* The launcher under ``torchrun`` on 4 ranks, and its checkpoint resumed
  on one process.
"""
import math
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_arch
from repro_torch.models import transformer as tt

LOSS1 = 1e-6
REL = 1e-5
TRAJ = 1e-4
STEPS = 4
BATCH = 4
SEQ = 8
ROOT = Path(__file__).resolve().parents[1]
# A SMOKE config of each block kind and its overrides.
CONFIGS = {"qwen3_0_6b": {}, "deepseek_coder_33b": {"optimizer": "adafactor"},
           "llama4_scout_17b_a16e": {}, "recurrentgemma_9b": {},
           "xlstm_1_3b": {}, "llama_3_2_vision_11b": {}}
POD_STEPS = 5


def _batches(cfg, rng, n, batch):
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (batch, SEQ + 1)).astype(
            np.int32)
        mask = (rng.random((batch, SEQ)) < 0.75).astype(np.float32)
        mask[0, :2] = 1.0
        b = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
        if cfg.vision_dim:
            b["vision"] = rng.standard_normal(
                (batch, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
        out.append(b)
    return out


_REF = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro import train as jtrain
from repro.configs import get_smoke_arch
from repro.train import trainer as jtrainer
with open(sys.argv[1], "rb") as f:
    data = pickle.load(f)
out = {}
for arch in sys.argv[4].split(","):
    entry = data[arch]
    cfg = dataclasses.replace(get_smoke_arch(arch), **entry["over"])
    s = jtrain.TrainSettings(total_steps=20, warmup_steps=2)
    state = jtrain.init_train_state(cfg, s)
    state = dict(state, params=jax.tree.map(jnp.asarray, entry["params"]))
    batches = [jax.tree.map(jnp.asarray, b) for b in entry["batches"]]

    def both(state, b):
        # One compile: the gradient beside the step.
        (loss, _), grads = jax.value_and_grad(
            lambda p: jtrainer._loss_fn(cfg, s, p, b), has_aux=True)(
                state["params"])
        return loss, grads, jtrain.make_train_step(cfg, s)(state, b)

    step = jax.jit(both)
    metrics = []
    for i, b in enumerate(batches):
        loss, grads, (state, m) = step(state, b)
        if i == 0:
            first = (float(loss), [np.asarray(g)
                                   for g in jax.tree.leaves(grads)])
        metrics.append({k: float(v) for k, v in m.items()})
    out[arch] = {"loss1": first[0], "grad1": first[1], "metrics": metrics,
                 "params": [np.asarray(p)
                            for p in jax.tree.leaves(state["params"])]}
if sys.argv[2]:
    with open(sys.argv[2], "rb") as f:
        pods = pickle.load(f)
    cfg = dataclasses.replace(get_smoke_arch("qwen3_0_6b"), num_heads=4,
                              num_kv_heads=2)
    s = jtrain.TrainSettings(sync_mode="digest", n_pod=2, sync_interval=5,
                             total_steps=20, warmup_steps=2)
    state = jtrain.init_train_state(cfg, s)
    state = dict(state, params=jax.tree.map(
        lambda p: jnp.stack([jnp.asarray(p)] * 2), pods["params"]))
    step = jax.jit(jtrain.make_train_step(cfg, s))
    metrics = []
    for b in pods["batches"]:
        state, m = step(state, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    out["pods"] = {"metrics": metrics,
                   "params": [np.asarray(p)
                              for p in jax.tree.leaves(state["params"])]}
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


# The reference's configs in two subprocesses of about equal compile time
# (the second with the pod form).
REF_SPLIT = (("recurrentgemma_9b", "xlstm_1_3b", "llama_3_2_vision_11b"),
             ("qwen3_0_6b", "deepseek_coder_33b", "llama4_scout_17b_a16e"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four- and eight-rank jobs, with the reference (two
    subprocesses) running beside them."""
    import test_torch_mesh as tm
    from test_torch_sharding import _numpy_params
    tmp = tmp_path_factory.mktemp("tp_train")
    rng = np.random.default_rng(28)
    data = {}
    for arch, over in CONFIGS.items():
        cfg = get_smoke_arch(arch)
        data[arch] = {"over": over,
                      "params": _numpy_params(tt.arch_specs(cfg), rng),
                      "batches": _batches(cfg, rng, STEPS, BATCH)}
    pcfg = get_smoke_arch("qwen3_0_6b")
    pods = {"params": _numpy_params(tt.arch_specs(pcfg), rng),
            "batches": _batches(pcfg, rng, POD_STEPS, 8)}
    inputs, pod_inputs = str(tmp / "inputs.pkl"), str(tmp / "pods.pkl")
    for path, obj in ((inputs, data), (pod_inputs, pods)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    refs = [str(tmp / f"ref{i}.pkl") for i in range(len(REF_SPLIT))]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REF, inputs,
         pod_inputs if i == len(REF_SPLIT) - 1 else "", path,
         ",".join(archs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, (archs, path) in enumerate(zip(REF_SPLIT, refs))]
    try:
        ranks = tm.spawn("tp_train_job", 4, inputs=inputs)
        pod_ranks = tm.spawn("tp_pod_job", 8, inputs=pod_inputs)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    ref = {}
    for p, log, path in zip(procs, logs, refs):
        assert p.returncode == 0, log
        with open(path, "rb") as f:
            ref.update(pickle.load(f))
    return ranks, pod_ranks, ref


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-30)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("arch", list(CONFIGS))
def test_sharded_step_matches_reference(runs, arch, mesh):
    """The step-1 loss, each leaf of the step-1 gradient and the 4-step
    metrics against the reference's single device; the largest relative
    difference of the params after 4 steps is printed (Adam's first step
    carries the sums' rounding into the params)."""
    ranks, _, ref = runs
    want = ref[arch]
    for r in ranks:
        got = r["archs"][arch][mesh]
        assert _rel(got["metrics"][0]["loss"], want["loss1"]) <= LOSS1
        for i, (g, w) in enumerate(zip(got["metrics"], want["metrics"])):
            for k in ("loss", "ce", "aux"):
                assert abs(g[k] - w[k]) <= TRAJ * max(abs(w[k]), 1e-30), (
                    i, k, g[k], w[k])
    got = ranks[0]["archs"][arch][mesh]
    assert len(got["grad1"]) == len(want["grad1"])
    for i, (g, w) in enumerate(zip(got["grad1"], want["grad1"])):
        assert g.shape == w.shape, i
        err = np.abs(g - w).max()
        assert err <= REL * max(np.abs(w).max(), 1e-30), (i, err)
    print(arch, mesh, "params after 4 steps, max |d| / max |p| of a leaf:",
          max(float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
              for g, w in zip(got["params"], want["params"])))


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_every_rank_holds_the_same_bits(runs, mesh):
    """After 4 steps every rank's whole params (its blocks gathered) are
    the same bits: the data replicas step on the same gradients and
    statistics, and the ranks of a "model" group add in the same order."""
    ranks, _, _ = runs
    for arch in CONFIGS:
        digests = {tuple(r["archs"][arch][mesh]["digests"]) for r in ranks}
        assert len(digests) == 1, arch


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_sharded_step_census(runs, mesh):
    """Every rank counts the same collectives each step: gathers, and
    where "data" splits the batch and cuts the parameters, the one
    ``all_reduce`` of the mask count and the FSDP backward's all-to-alls;
    no point-to-point op or barrier."""
    ranks, _, _ = runs
    fsdp = mesh == "2x2"
    for arch in CONFIGS:
        census = [r["archs"][arch][mesh]["census"] for r in ranks]
        assert all(c == census[0] for c in census), arch
        for step in census[0]:
            assert step["all_gather"] > 0
            assert step.get("all_reduce", 0) == fsdp, (arch, step)
            assert (step.get("all_to_all", 0) > 0) == fsdp, (arch, step)
            assert set(step) <= {"all_gather", "all_reduce",
                                 "all_to_all"}, step


def test_whole_leaf_statistics_on_cut_leaves(runs):
    """The vocab-parallel NLL (and its gradient block), the global norm
    and one Adafactor update of leaves cut over "data", "model" and both
    equal the whole tensors' within float32 rounding."""
    ranks, _, _ = runs
    for r in ranks:
        u = r["units"]
        assert u["nll"] <= 1e-6 and u["nll_grad"] <= 1e-6, u
        assert u["norm"] <= 1e-6 and u["adafactor"] <= 1e-6, u


def test_kill_and_resume_across_meshes_is_bitwise(runs):
    """Two steps on the 2 x 2 mesh, the whole state written, restored on
    one process (equal to the gathered state) and written again, then
    restored and cut over the mesh and two more steps: every rank's state
    equals the run without a stop, bit for bit (deepseek-coder-33b SMOKE,
    Adafactor's factored state)."""
    ranks, _, _ = runs
    assert all(r["resume"]["equal"] for r in ranks)
    assert ranks[0]["resume"]["one_equal"]


def test_pod_form_over_pod_data_model_matches_reference(runs):
    """(pod 2, data 2, model 2), 5 steps at interval 5: each step's loss,
    ce and aux (the pods' mean) within 1e-4 of the reference's stacked
    form, every rank the same metrics; after the sync at step 5 every
    rank holds the same whole params; census, the same on every rank:
    the sync step gathers the params once more."""
    _, ranks, ref = runs
    want = ref["pods"]["metrics"]
    for r in ranks:
        for i, (g, w) in enumerate(zip(r["metrics"], want)):
            for k in ("loss", "ce", "aux"):
                assert abs(g[k] - w[k]) <= TRAJ * max(abs(w[k]), 1e-30), (
                    i, k)
        assert r["metrics"] == ranks[0]["metrics"]
        assert r["census"] == ranks[0]["census"]
    census = ranks[0]["census"]
    assert all(c == census[0] for c in census[:POD_STEPS - 1])
    assert census[-1] == dict(census[0],
                              all_gather=census[0]["all_gather"] + 1)
    assert len({tuple(r["digests"]) for r in ranks}) == 1
    for pod in (0, 1):
        print("pod", pod, "params after the sync, max |d| / max |p|:",
              max(float(np.abs(g - w[pod]).max()
                        / max(np.abs(w[pod]).max(), 1e-30))
                  for g, w in zip(ranks[pod * 4]["params"],
                                  ref["pods"]["params"])))


def test_train_launcher_under_torchrun_on_the_cpu(tmp_path, capsys):
    """``launch/train.py --data-axis 2 --model-axis 2 --dist-backend gloo``
    under ``torchrun`` on the CPU: each rank prints the bytes of params
    and of train state it holds (its blocks: a quarter of each leaf cut
    over both, half of one cut over one), and its checkpoint (the whole
    state) resumes on one process."""
    from repro_torch.distributed import local_bytes, train_state_specs
    from repro_torch.launch import train as tlaunch
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--smoke", "--arch", "qwen3-0.6b", "--steps",
         "2", "--batch", "4", "--seq", "8", "--log-every", "1",
         "--data-axis", "2", "--model-axis", "2", "--dist-backend", "gloo",
         "--ckpt-dir", ckpt],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    got = re.findall(r"rank (\d): (\d+) bytes of params, (\d+) bytes of "
                     r"train state", out.stdout)
    cfg = get_smoke_arch("qwen3-0.6b")
    sizes = {"data": 2, "model": 2}
    specs = tt.arch_specs(cfg)
    want = (local_bytes(specs, sizes, {"embed": "data"}),
            local_bytes(train_state_specs(specs, cfg.optimizer), sizes,
                        {"embed": "data"}))
    assert sorted(got) == [(str(r), str(want[0]), str(want[1]))
                           for r in range(4)], out.stdout
    assert want[0] < local_bytes(specs, {}) // 2
    assert "mesh={'data': 2, 'model': 2}" in out.stdout
    assert "saved" in out.stdout
    res = tlaunch.main(["--device", "cpu", "--smoke", "--arch",
                        "qwen3-0.6b", "--steps", "1", "--batch", "4",
                        "--seq", "8", "--ckpt-dir", ckpt])
    assert "resumed from step 2" in capsys.readouterr().out
    assert int(res["state"]["step"]) == 3
    assert math.isfinite(res["losses"][0])
