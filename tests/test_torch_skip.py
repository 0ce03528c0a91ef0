"""K4, the chunk-skipping streamed halo pull, against the reference.

The port's plain version of K4 (what its wrapper runs on CPU tensors)
against ``halo_spmm_skip_pallas`` in interpret mode and against both
packages' ``halo_spmm_skip_ref``, for fp32 / bf16 / int8 slabs with and
without the SAT predictor slab: tolerance 1e-6 (atol = rtol), since the
port sums each chunk's partial sequentially over k like the Pallas body
and the oracles reduce vectorised.  Against the port's own K3 plain
version K4 is held bit for bit, its visits to its worklist exactly, and
its geometry guards raise as the reference's do.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import halo_exchange as jhx
from repro.kernels.spmm import halo_spmm_skip_pallas
from repro.kernels.spmm import halo_spmm_skip_ref as j_skip_ref
from repro_torch.core import digest as tdigest
from repro_torch.graph import build_chunk_worklist, make_dataset
from repro_torch.kernels.spmm import (halo_spmm, halo_spmm_skip_cuda,
                                      halo_spmm_skip_plain,
                                      halo_spmm_skip_ref,
                                      halo_spmm_stream_plain,
                                      select_halo_kernel)

TOL = dict(atol=1e-6, rtol=1e-6)
CHUNK = 128


def _case(seed, rows=256, deg=6, n_tab=700, feat=128):
    """Clustered references (each 128-row block reads its own slab
    range), so the worklist skips chunks; the last slab row is the zero
    sentinel every padding slot points at."""
    rng = np.random.default_rng(seed)
    nbr = np.empty((rows, deg), np.int32)
    for b in range(0, rows, 128):
        lo = (b // 128) * 300
        nbr[b:b + 128] = rng.integers(lo, min(lo + 250, n_tab - 1),
                                      size=(min(128, rows - b), deg))
    pad = rng.random((rows, deg)) < 0.2
    nbr[pad] = n_tab - 1
    wts = (rng.random((rows, deg)) * ~pad).astype(np.float32)
    table = rng.normal(size=(n_tab, feat)).astype(np.float32)
    table[-1] = 0
    ptable = rng.normal(size=(n_tab, feat)).astype(np.float32)
    ptable[-1] = 0
    return nbr, wts, table, ptable


def _slab(table, storage):
    data, scale = jhx.quantize_rows(jnp.asarray(table),
                                    jhx.HaloPrecision(storage))
    return np.asarray(data), (None if scale is None else np.asarray(scale))


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _tb(a):
    """bf16 numpy (ml_dtypes) → torch bf16, bit for bit."""
    if a.dtype == np.float32 or a.dtype == np.int8:
        return _t(a)
    return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
def test_skip_plain_matches_reference(storage, pred):
    nbr, wts, table, ptable = _case(11)
    wl = build_chunk_worklist(nbr, table.shape[0], CHUNK)
    assert wl.occupancy < 1.0            # the worklist really skips
    data, scale = _slab(table, storage)
    pdata = pscale = None
    if pred:
        pdata, pscale = _slab(ptable, storage)
    gamma = 0.7
    want = halo_spmm_skip_pallas(
        jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(data),
        None if scale is None else jnp.asarray(scale),
        wl_ids=jnp.asarray(wl.ids), wl_cnt=jnp.asarray(wl.cnt),
        pdata=None if pdata is None else jnp.asarray(pdata),
        pscale=None if pscale is None else jnp.asarray(pscale),
        gamma=gamma, chunk_rows=CHUNK, interpret=True)
    jref = j_skip_ref(jnp.asarray(nbr), jnp.asarray(wts), jnp.asarray(data),
                      None if scale is None else jnp.asarray(scale),
                      wl.ids, wl.cnt, CHUNK,
                      pdata=None if pdata is None else jnp.asarray(pdata),
                      pscale=None if pscale is None else jnp.asarray(pscale),
                      gamma=gamma)
    args = (_t(nbr), _t(wts), _tb(data), _t(scale), _t(wl.ids),
            _t(wl.cnt), None if pdata is None else _tb(pdata), _t(pscale))
    got = halo_spmm_skip_cuda(*args, gamma=gamma, chunk_rows=CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(jref), **TOL)
    tref = halo_spmm_skip_ref(*args[:4], args[4], args[5], CHUNK,
                              pdata=args[6], pscale=args[7], gamma=gamma)
    np.testing.assert_allclose(tref.numpy(), np.asarray(jref), **TOL)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_skip_equals_stream_and_visits_worklist(storage):
    nbr, wts, table, _ = _case(12, rows=300)
    wl = build_chunk_worklist(nbr, table.shape[0], CHUNK)
    data, scale = _slab(table, storage)
    args = (_t(nbr), _t(wts), _tb(data), _t(scale))
    k4, visits = halo_spmm_skip_cuda(*args, _t(wl.ids), _t(wl.cnt),
                                     chunk_rows=CHUNK, count_visits=True)
    k3 = halo_spmm_stream_plain(*args, chunk_rows=CHUNK)
    assert torch.equal(k4, k3)
    t = np.arange(wl.max_chunks)[None, :]
    want = np.where(t < wl.cnt[:, None], wl.ids, -1)
    np.testing.assert_array_equal(visits.numpy(), want)


def test_truncated_worklist_diverges():
    """Drop one visited chunk of block 0: both the kernel's plain version
    and the oracle lose exactly that chunk's terms."""
    nbr, wts, table, _ = _case(13)
    wl = build_chunk_worklist(nbr, table.shape[0], CHUNK)
    cnt = wl.cnt.copy()
    cnt[0] -= 1
    args = (_t(nbr), _t(wts), _t(table), None, _t(wl.ids), _t(cnt))
    got = halo_spmm_skip_cuda(*args, chunk_rows=CHUNK)
    full = halo_spmm_stream_plain(*args[:4], chunk_rows=CHUNK)
    assert not torch.allclose(got[:128], full[:128])
    assert torch.equal(got[128:], full[128:])
    ref = halo_spmm_skip_ref(*args, CHUNK)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)


def test_skip_geometry_guards():
    nbr, wts, table, _ = _case(14)
    wl = build_chunk_worklist(nbr, table.shape[0], CHUNK)
    args = (_t(nbr), _t(wts), _t(table))
    with pytest.raises(ValueError, match="worklist"):
        halo_spmm_skip_cuda(*args, chunk_rows=CHUNK)
    with pytest.raises(ValueError, match="row blocks"):
        halo_spmm_skip_cuda(*args, None, _t(wl.ids[:1]), _t(wl.cnt[:1]),
                            chunk_rows=CHUNK)
    fine = build_chunk_worklist(nbr, table.shape[0], 32)
    assert fine.max_chunks > -(-table.shape[0] // CHUNK)
    with pytest.raises(ValueError, match="chunk-geometry"):
        halo_spmm_skip_cuda(*args, None, _t(fine.ids), _t(fine.cnt),
                            chunk_rows=CHUNK)
    with pytest.raises(ValueError, match="backend"):
        halo_spmm(*args, backend="pallas_skip")


def test_skip_raises_on_grad():
    nbr, wts, table, _ = _case(15)
    wl = build_chunk_worklist(nbr, table.shape[0], CHUNK)
    data = _t(table).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        halo_spmm_skip_cuda(_t(nbr), _t(wts), data, None, _t(wl.ids),
                            _t(wl.cnt), chunk_rows=CHUNK)
    with torch.no_grad():
        halo_spmm_skip_cuda(_t(nbr), _t(wts), data, None, _t(wl.ids),
                            _t(wl.cnt), chunk_rows=CHUNK)


def test_ladder_selects_skip_on_a_partition():
    """A real partition's per-subgraph out-ELL and worklist, with the
    stream forced by a tiny budget and the skip rung by
    ``skip_occupancy_max=1.0``: halo_spmm runs K4, equal to K3."""
    g = make_dataset("flickr-sim", scale=0.3, seed=3)
    data = tdigest.prepare_graph_data(g, 3, seed=0, stream_chunk_rows=32,
                                      order="rcm", device="cpu")
    wl = data["_worklist"]
    st = {k: v[1] for k, v in data["struct"].items()}
    n_tab = data["halo_ids"].shape[1] + 1
    rng = np.random.default_rng(4)
    slab = torch.from_numpy(rng.normal(size=(n_tab, 24)).astype(np.float32))
    slab[-1] = 0
    kw = dict(resident_max_bytes=64, occupancy=wl.occupancy,
              skip_occupancy_max=1.0, chunk_rows=32)
    assert select_halo_kernel(slab, has_worklist=True,
                              resident_max_bytes=64, occupancy=wl.occupancy,
                              skip_occupancy_max=1.0) == "skip"
    got = halo_spmm(st["out_nbr"], st["out_wts"], slab,
                    wl_ids=st["wl_ids"], wl_cnt=st["wl_cnt"], **kw)
    k3 = halo_spmm_stream_plain(st["out_nbr"], st["out_wts"], slab,
                                chunk_rows=32)
    assert torch.equal(got, k3)
    plain = halo_spmm_skip_plain(st["out_nbr"], st["out_wts"], slab, None,
                                 st["wl_ids"], st["wl_cnt"], chunk_rows=32)
    assert torch.equal(got, plain)
