"""Checkpoints in the port: the reference's nine cases
(``tests/test_checkpoint.py``) on tensors, and the layout across
packages — equal arrays give equal keys and CRCs in both packages'
manifests, and a GCN state the reference's ``digest_train`` checkpointed
after 4 epochs restores into the port's ``init_state`` template, from
which the port's next 4 epochs track the reference's within 1e-4 (the
training parity bar of ``tests/test_torch_train.py``)."""
import os
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.core import digest as jdigest
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro_torch import optim as toptim
from repro_torch.checkpoint import (CheckpointCorruptError, latest_step,
                                    read_manifest, restore_checkpoint,
                                    save_checkpoint, verify_checkpoint)
from repro_torch.core import digest as tdigest
from repro_torch.core import halo_exchange as hx
from repro_torch.models import gnn as tgnn


def test_roundtrip(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3),
                       "layers": [torch.ones((2,)), torch.zeros((3,))]},
            "step": 7, "none": None}
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    assert sorted(read_manifest(str(tmp_path), 7)["keys"]) == [
        "params/layers/0", "params/layers/1", "params/w", "step"]
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 7
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert torch.equal(restored["params"]["layers"][0],
                       tree["params"]["layers"][0])
    assert restored["step"] == 7 and isinstance(restored["step"], int)
    assert restored["none"] is None


def test_latest_of_many(tmp_path):
    tree = {"x": torch.zeros((2,))}
    for s in (1, 5, 3):
        save_checkpoint(str(tmp_path), s, tree)
    assert latest_step(str(tmp_path)) == 5


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros((2,))})
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), {"x": torch.zeros((3,))})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"y": torch.zeros((2,))})


def test_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), {"x": torch.zeros(1)})


def test_truncated_npz_falls_back_to_previous(tmp_path):
    tree = {"x": torch.arange(4096.0)}
    save_checkpoint(str(tmp_path), 3, tree)
    save_checkpoint(str(tmp_path), 6, tree)
    npz = tmp_path / "ckpt_00000006.npz"
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) // 2)
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(str(tmp_path), 6)
    assert latest_step(str(tmp_path)) == 3
    restored, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 3
    assert torch.equal(restored["x"], tree["x"])


def test_checksum_mismatch_detected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.zeros((8,))})
    save_checkpoint(str(tmp_path), 2, {"x": torch.ones((8,))})
    shutil.copy(tmp_path / "ckpt_00000001.npz", tmp_path / "ckpt_00000002.npz")
    with pytest.raises(CheckpointCorruptError, match="CRC32"):
        verify_checkpoint(str(tmp_path), 2)
    assert latest_step(str(tmp_path)) == 1


def test_corrupt_manifest_and_partial_writes_skipped(tmp_path):
    tree = {"x": torch.zeros((4,))}
    save_checkpoint(str(tmp_path), 1, tree)
    save_checkpoint(str(tmp_path), 4, tree)
    (tmp_path / "ckpt_00000004.json").write_text("{not json")
    with pytest.raises(CheckpointCorruptError):
        read_manifest(str(tmp_path), 4)
    save_checkpoint(str(tmp_path), 5, tree)
    os.unlink(tmp_path / "ckpt_00000005.npz")
    save_checkpoint(str(tmp_path), 6, tree)
    os.unlink(tmp_path / "ckpt_00000006.json")
    assert latest_step(str(tmp_path)) == 1
    _, step = restore_checkpoint(str(tmp_path), tree)
    assert step == 1
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_bf16_store_roundtrip(tmp_path):
    store = hx.init_store(1, 4, 8, hx.HaloPrecision("bf16"), "cpu")
    store = hx.push(store, torch.tensor([[0, 2]]), torch.ones((1, 2),
                                                              dtype=bool),
                    torch.from_numpy(np.random.default_rng(0).normal(
                        size=(1, 1, 2, 8)).astype(np.float32)))
    save_checkpoint(str(tmp_path), 1, {"store": store})
    restored, _ = restore_checkpoint(str(tmp_path), {"store": store})
    assert restored["store"]["data"].dtype == torch.bfloat16
    assert torch.equal(restored["store"]["data"], store["data"])


def test_compact_halo_store_roundtrip(tmp_path):
    store = hx.init_store(2, 9, 8, hx.HaloPrecision("int8"), "cpu")
    slots = torch.tensor([[0, 4, 8]])
    valid = torch.tensor([[True, True, False]])
    reps = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 2, 3, 8)).astype(np.float32))
    store = hx.push(store, slots, valid, reps)
    state = {"store": store, "step": 5}
    save_checkpoint(str(tmp_path), 5, state, meta={"halo_storage": "int8"})
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 5
    assert restored["store"]["data"].dtype == torch.int8
    assert torch.equal(restored["store"]["data"], store["data"])
    assert torch.equal(restored["store"]["scale"], store["scale"])
    assert read_manifest(str(tmp_path), 5)["meta"]["halo_storage"] == "int8"


def test_manifests_agree_across_packages(tmp_path):
    """Equal arrays (bf16 and int8 stores, ints as 0-d int32) give the
    same keys and CRCs in both packages' manifests, and each package
    restores the other's checkpoint to the same bits."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    q = rng.integers(-127, 128, size=(2, 5, 8)).astype(np.int8)
    b = rng.normal(size=(3, 8)).astype(np.float32)
    jtree = {"params": {"layer_0": {"w": jnp.asarray(w)}},
             "store": {"data": jnp.asarray(q),
                       "bf": jnp.asarray(b).astype(jnp.bfloat16)},
             "list": [jnp.ones((2,)), jnp.zeros((1,), jnp.int32)],
             "epoch": jnp.asarray(4, jnp.int32)}
    ttree = {"params": {"layer_0": {"w": torch.from_numpy(w)}},
             "store": {"data": torch.from_numpy(q),
                       "bf": torch.from_numpy(b).to(torch.bfloat16)},
             "list": [torch.ones((2,)), torch.zeros((1,), dtype=torch.int32)],
             "epoch": 4}
    jckpt.save_checkpoint(str(tmp_path / "j"), 4, jtree)
    save_checkpoint(str(tmp_path / "t"), 4, ttree)
    jm = jckpt.read_manifest(str(tmp_path / "j"), 4)
    tm = read_manifest(str(tmp_path / "t"), 4)
    assert tm["keys"] == jm["keys"]
    assert tm["checksums"] == jm["checksums"]
    from_j, _ = restore_checkpoint(str(tmp_path / "j"), ttree)
    assert all(torch.equal(x, y) for x, y in zip(
        jax.tree.leaves(from_j), jax.tree.leaves(ttree))
        if isinstance(x, torch.Tensor))
    assert from_j["epoch"] == 4
    from_t, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), jtree)
    for x, y in zip(jax.tree.leaves(from_t), jax.tree.leaves(jtree)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    jdata = jdigest.prepare_graph_data(g, 2, seed=0)
    tdata = tdigest.prepare_graph_data(g, 2, seed=0, device="cpu")
    base = dict(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1)
    jcfg, tcfg = jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)
    jset = jdigest.TrainSettings(sync_interval=2)
    tset = tdigest.TrainSettings(sync_interval=2)
    d = str(tmp_path)
    _, jhist = jdigest.digest_train(jcfg, joptim.adam(5e-3), jdata, jset, 8,
                                    eval_every=1)
    jdigest.digest_train(jcfg, joptim.adam(5e-3), jdata, jset, 4,
                         eval_every=4, ckpt_dir=d, ckpt_every=4)
    # The port's template takes the reference's checkpoint as it stands.
    template = tdigest.init_state(tcfg, toptim.adam(5e-3), tdata)
    state, step = restore_checkpoint(d, template)
    assert step == 4 and state["epoch"] == 4 and state["step"] == 4
    ref = np.load(os.path.join(d, "ckpt_00000004.npz"))
    np.testing.assert_array_equal(state["params"]["layer_0"]["w"].numpy(),
                                  ref["params/layer_0/w"])
    # The port's digest_train (its own initial draw overwritten by the
    # restore) resumes from it and runs epochs 5-8.
    tst, thist = tdigest.digest_train(
        tcfg, toptim.adam(5e-3), tdata, tset, 8, eval_every=1, ckpt_dir=d,
        resume=True)
    assert thist["epoch"] == [5, 6, 7, 8]
    np.testing.assert_allclose(thist["loss"], jhist["loss"][4:], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(thist["train_f1"], jhist["train_f1"][4:],
                               rtol=0, atol=1e-4)
    # And the port's checkpoint of its own state carries the same keys.
    save_checkpoint(str(tmp_path / "t"), 8, tst)
    assert read_manifest(str(tmp_path / "t"), 8)["keys"] == \
        jckpt.read_manifest(d, 4)["keys"]



def test_sharded_run_checkpoints_whole_and_resumes(tmp_path):
    """A collective run on 2 gloo ranks (GCN int8 with error feedback, the
    ema predictor, drop faults and watchdog 3; tests/test_torch_mesh.py)
    checkpoints whole arrays: restored whole it equals the single-process
    run's state, restored with ``sharding=`` each rank's part, and resumed
    from epoch 4 to 6 it equals the unbroken collective run and, gathered,
    the single-process run — all bit for bit."""
    import test_torch_mesh as tm
    for rank in tm.spawn("checkpoint_job", 2, ckpt_dir=str(tmp_path)):
        assert rank["step"] == 4
        assert rank["whole_is_single"]
        assert rank["placed_is_rank_state"]
        assert rank["resumed_is_unbroken"]
        assert rank["resumed_is_single"]
