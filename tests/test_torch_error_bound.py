"""Theorem-1 instrumentation in the port against the reference.

The reference trains 5 epochs (flickr-sim at scale 0.15, 2 parts, GCN
3 x 16, interval 2, the ``ema`` predictor), and its params, store and
pstore go, as numpy, into both packages' ``measure_error_and_bound`` and
``quantization_eps``, for fp32, bf16 and int8 stores, with and without
the pstore.  ε, its means, ε_quant, the bounds and the Lipschitz
estimates agree within 1e-5 relative.  The gradient norms
(``err_measured``, ``grad_norm_fresh``) are held to 1e-4: each is the
norm of a mean of per-subgraph gradients that the two packages sum in
other orders, and ``err_measured`` is the norm of a difference of two
such gradients, which loses the digits the two have in common.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro import optim as joptim
from repro.core import digest as jdigest
from repro.core import error_bound as jeb
from repro.core import halo_exchange as jhx
from repro.core import predictor as jpred
from repro.graph import make_dataset
from repro.models import gnn as jgnn
from repro_torch.core import digest as tdigest
from repro_torch.core import error_bound as teb
from repro_torch.models import gnn as tgnn
from repro_torch.nn import params_from_numpy

REL = 1e-5
GRAD_REL = 1e-4
GRAD_KEYS = ("err_measured", "grad_norm_fresh")


@functools.lru_cache(maxsize=None)
def _trained(storage):
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    jdata = jdigest.prepare_graph_data(g, 2, seed=0)
    tdata = tdigest.prepare_graph_data(g, 2, seed=0, device="cpu")
    base = dict(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                hidden_dim=16, num_classes=int(g.labels.max()) + 1)
    jcfg, tcfg = jgnn.GNNConfig(**base), tgnn.GNNConfig(**base)
    settings = jdigest.TrainSettings(
        sync_interval=2, precision=jhx.HaloPrecision(storage),
        predictor=jpred.PredictorConfig("ema"))
    state, _ = jdigest.digest_train(jcfg, joptim.adam(5e-3), jdata,
                                    settings, 5, eval_every=5)
    return jcfg, tcfg, jdata, tdata, state


def _to_torch(tree):
    def leaf(x):
        a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16
                       else x)
        t = torch.from_numpy(np.array(a))
        return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t
    return {k: leaf(v) for k, v in tree.items()}


def _close(got, want, rel, key):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), 1e-30)
    assert np.all(np.abs(got - want) <= rel * scale), (key, got, want)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("with_pstore", [False, True])
def test_error_and_bound_match_reference(storage, with_pstore):
    jcfg, tcfg, jdata, tdata, state = _trained(storage)
    jp = state["params"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    kw_j, kw_t = {}, {}
    if with_pstore:
        kw_j = dict(pstore=state["pstore"], gamma=0.8)
        kw_t = dict(pstore=_to_torch(state["pstore"]), gamma=0.8)
    want = jeb.measure_error_and_bound(jcfg, jp, jdata, state["store"],
                                       **kw_j)
    got = teb.measure_error_and_bound(tcfg, tp, tdata,
                                      _to_torch(state["store"]), **kw_t)
    assert set(got) == set(want)
    assert got["storage"] == want["storage"] == storage
    for key, value in want.items():
        if key == "storage":
            continue
        _close(got[key], value, GRAD_REL if key in GRAD_KEYS else REL, key)
    if with_pstore:
        assert got["eps_raw_mean"] != got["eps_mean"]
    assert got["err_measured"] > 0 and got["bound"] > 0


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_quantization_eps_matches_reference(storage):
    _, _, jdata, tdata, state = _trained(storage)
    want = jeb.quantization_eps(state["store"], jdata)
    got = teb.quantization_eps(_to_torch(state["store"]), tdata)
    _close(got, want, REL, storage)
    assert (np.all(got == 0) if storage == "fp32" else np.all(got > 0))


def test_fresh_halo_cache_matches_reference():
    jcfg, tcfg, jdata, tdata, state = _trained("fp32")
    jp = state["params"]
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    want = np.asarray(jeb.fresh_halo_cache(jcfg, jp, jdata))
    got = teb.fresh_halo_cache(tcfg, tp, tdata).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
