"""The port's SpMM / halo-SpMM plain versions against the reference's
Pallas kernels (interpret mode), the selection ladder against the
reference ladder, and int8 codes bit for bit.

Tolerance 1e-5 (atol = rtol): the port sums each row sequentially over k
like the TPU kernels, the oracles with a vectorised reduction; bf16 and
int8 rows are upcast exactly, so they need no looser bar.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import halo_exchange as jhx
from repro.kernels.spmm import halo_spmm_stream_pallas
from repro.kernels.spmm import ops as jops
from repro_torch.core import halo_exchange as thx
from repro_torch.graph import build_chunk_worklist
from repro_torch.kernels import _build
from repro_torch.kernels.spmm import (halo_spmm, halo_spmm_cuda,
                                      halo_spmm_ref, halo_spmm_stream_cuda,
                                      select_halo_kernel, spmm, spmm_cuda,
                                      spmm_ref)

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [(128, 4, 64, 128), (256, 16, 300, 128), (128, 1, 5, 256),
          (384, 9, 57, 70), (17, 3, 9, 33)]


def _case(rng, rows, deg, ncols, feat):
    nbr = rng.integers(0, ncols + 1, size=(rows, deg)).astype(np.int32)
    wts = (rng.random((rows, deg)) * (nbr < ncols)).astype(np.float32)
    table = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    table[-1] = 0
    return nbr, wts, table


def _slab(table, storage):
    """Quantise with the reference; sentinel row exact zero."""
    data, scale = jhx.quantize_rows(jnp.asarray(table),
                                    jhx.HaloPrecision(storage))
    data = data.at[-1].set(0)
    return data, scale


def _t(x):
    """numpy / jax array → CPU tensor (bf16 through an exact fp32 hop)."""
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)


@pytest.mark.parametrize("rows,deg,ncols,feat", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_matches_reference_kernel(rows, deg, ncols, feat, dtype):
    rng = np.random.default_rng(rows + deg)
    nbr, wts, table = _case(rng, rows, deg, ncols, feat)
    jtab = jnp.asarray(table).astype(dtype)
    want = jops.spmm(jnp.asarray(nbr), jnp.asarray(wts), jtab,
                     backend="pallas_interpret")
    ttab = _t(jtab)
    _close(spmm_cuda(_t(nbr), _t(wts), ttab), want)
    _close(spmm(_t(nbr), _t(wts), ttab, backend="jnp"), want)
    _close(spmm_ref(_t(nbr), _t(wts), ttab), want)


@pytest.mark.parametrize("shape", [(64, 6, 50, 48), (17, 3, 9, 33),
                                   (128, 6, 300, 64)])
@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
def test_halo_spmm_matches_reference_kernels(shape, storage, pred):
    """K2's and K3's plain versions against the reference's resident and
    streamed kernels, at every precision, with and without the SAT
    epilogue; the 300-row slab at chunk_rows=128 ends in a ragged chunk."""
    rows, deg, ncols, feat = shape
    rng = np.random.default_rng(11 + rows)
    nbr, wts, table = _case(rng, rows, deg, ncols, feat)
    data, scale = _slab(table, storage)
    pdata = pscale = None
    gamma = 1.0
    if pred:
        pdata, pscale = _slab(rng.normal(size=table.shape)
                              .astype(np.float32), storage)
        gamma = 0.7
    jn, jw = jnp.asarray(nbr), jnp.asarray(wts)
    want = jops.halo_spmm(jn, jw, data, scale, pdata=pdata, pscale=pscale,
                          gamma=gamma, backend="pallas_interpret")
    want_stream = halo_spmm_stream_pallas(jn, jw, data, scale, pdata=pdata,
                                          pscale=pscale, gamma=gamma,
                                          chunk_rows=128, interpret=True)
    args = (_t(nbr), _t(wts), _t(data), _t(scale), _t(pdata), _t(pscale),
            gamma)
    _close(halo_spmm_cuda(*args), want)
    _close(halo_spmm_ref(*args), want)
    _close(halo_spmm_stream_cuda(*args, chunk_rows=128), want_stream)
    _close(halo_spmm_stream_cuda(*args, chunk_rows=128), want)


def test_stream_single_chunk_equals_resident():
    """One chunk covering the slab: K3 == K2 exactly (port against port),
    through the wrappers and through ops.halo_spmm's forced stream."""
    rng = np.random.default_rng(19)
    nbr, wts, table = _case(rng, 128, 4, 60, 128)
    data, scale = _slab(table, "int8")
    n, w, d, s = _t(nbr), _t(wts), _t(data), _t(scale)
    want = halo_spmm_cuda(n, w, d, s)
    assert torch.equal(halo_spmm_stream_cuda(n, w, d, s, chunk_rows=64),
                       want)
    assert torch.equal(halo_spmm(n, w, d, s, backend="pallas_stream",
                                 chunk_rows=64), want)


def test_quantize_rows_int8_codes_bitwise():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(257, 96)).astype(np.float32)
    x[5] = 0.0                                   # all-zero row: 1e-12 floor
    x[6, :4] = [0.5, -0.5, 1.5, 2.5]             # exact half-way values
    x[6, 4:] = 0.0
    x[6, 4] = 127.0                              # scale 1: q == round(x)
    jq, js = jhx.quantize_rows(jnp.asarray(x), jhx.HaloPrecision("int8"))
    tq, ts = thx.quantize_rows(torch.from_numpy(x),
                               thx.HaloPrecision("int8"))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        thx.dequantize_rows(tq, ts).numpy(),
        np.asarray(jhx.dequantize_rows(jq, js)))


def _jax_selection(monkeypatch, data, scale, pdata, pscale, **knobs):
    """Which kernel the reference ladder calls, observed by replacing the
    three kernels with recorders and running the un-jitted body."""
    seen = []

    def recorder(name):
        def call(nbr, wts, data, *args, **kwargs):
            seen.append(name)
            return jnp.zeros((nbr.shape[0], data.shape[1]), jnp.float32)
        return call

    monkeypatch.setattr(jops, "halo_spmm_pallas", recorder("resident"))
    monkeypatch.setattr(jops, "halo_spmm_stream_pallas", recorder("stream"))
    monkeypatch.setattr(jops, "halo_spmm_skip_pallas", recorder("skip"))
    nbr = jnp.zeros((8, 2), jnp.int32)
    jops.halo_spmm.__wrapped__(nbr, jnp.zeros((8, 2), jnp.float32), data,
                               scale, pdata=pdata, pscale=pscale,
                               backend="pallas_interpret", **knobs)
    return seen[0]


def _stripe(rows, feat, itemsize, scale, pdata, pscale):
    s = rows * (min(128, feat) * itemsize + (4 if scale else 0))
    if pdata:
        s += rows * (min(128, feat) * itemsize + (4 if pscale else 0))
    return s


@pytest.mark.parametrize("storage,scale,pdata,pscale", [
    ("fp32", False, False, False), ("fp32", True, False, False),
    ("bf16", False, False, False), ("int8", True, False, False),
    ("int8", True, True, True), ("fp32", False, True, False),
    ("bf16", False, True, True)])
@pytest.mark.parametrize("delta", [0, 1])
def test_select_halo_kernel_matches_reference_ladder(
        monkeypatch, storage, scale, pdata, pscale, delta):
    """At the threshold (stripe == budget: resident) and one byte under it
    (stream), with and without scale / predictor slab."""
    rows, feat = 300, 160
    dtype = {"fp32": jnp.float32, "bf16": jnp.bfloat16,
             "int8": jnp.int8}[storage]
    jd = jnp.zeros((rows, feat), dtype)
    js = jnp.ones((rows, 1), jnp.float32) if scale else None
    jp = jnp.zeros((rows, feat), dtype) if pdata else None
    jps = jnp.ones((rows, 1), jnp.float32) if pscale else None
    budget = _stripe(rows, feat, jd.dtype.itemsize, scale, pdata,
                     pscale) - delta
    want = _jax_selection(monkeypatch, jd, js, jp, jps,
                          resident_max_bytes=budget)
    tdtype = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}[storage]
    td = torch.zeros((rows, feat), dtype=tdtype)
    ts = torch.ones((rows, 1)) if scale else None
    tp = torch.zeros((rows, feat), dtype=tdtype) if pdata else None
    tps = torch.ones((rows, 1)) if pscale else None
    got = select_halo_kernel(td, ts, tp, tps, resident_max_bytes=budget)
    assert got == want == ("resident" if delta == 0 else "stream")


@pytest.mark.parametrize("occupancy,expect", [(0.3, "skip"),
                                              (0.7, "stream")])
def test_select_halo_kernel_skip_rung(monkeypatch, occupancy, expect):
    """Above the budget with a worklist, low occupancy selects K4, and
    halo_spmm runs it: equal to K3 bit for bit (the worklist covers every
    referenced chunk).  Forcing ``pallas_skip`` runs it too."""
    jd = jnp.zeros((600, 128), jnp.float32)
    ids = jnp.zeros((1, 1), jnp.int32)
    want = _jax_selection(monkeypatch, jd, None, None, None,
                          wl_ids=ids, wl_cnt=jnp.ones((1,), jnp.int32),
                          resident_max_bytes=1024, occupancy=occupancy)
    td = torch.zeros((600, 128))
    got = select_halo_kernel(td, has_worklist=True, resident_max_bytes=1024,
                             occupancy=occupancy)
    assert got == want == expect
    rng = np.random.default_rng(3)
    td = torch.from_numpy(rng.normal(size=(600, 128)).astype(np.float32))
    n = torch.from_numpy(rng.integers(0, 300, size=(8, 2)).astype(np.int32))
    w = torch.from_numpy(rng.random((8, 2)).astype(np.float32))
    wl = build_chunk_worklist(n.numpy(), 600, 512)
    kw = dict(wl_ids=torch.from_numpy(wl.ids), wl_cnt=torch.from_numpy(wl.cnt))
    k3 = halo_spmm_stream_cuda(n, w, td)
    out = halo_spmm(n, w, td, resident_max_bytes=1024, occupancy=occupancy,
                    **kw)
    assert torch.equal(out, k3)
    assert torch.equal(halo_spmm(n, w, td, backend="pallas_skip", **kw), k3)


def test_cpu_tensors_never_launch():
    """On CPU tensors every wrapper runs its plain version: the launch
    counters stay 0, and nothing is built."""
    _build.reset_launches()
    rng = np.random.default_rng(5)
    nbr, wts, table = _case(rng, 40, 5, 700, 24)
    data, scale = _slab(table, "int8")
    n, w = _t(nbr), _t(wts)
    spmm(n, w, _t(table))
    halo_spmm(n, w, _t(data), _t(scale))
    halo_spmm(n, w, _t(data), _t(scale), resident_max_bytes=64)
    halo_spmm_stream_cuda(n, w, _t(table), chunk_rows=100)
    wl = build_chunk_worklist(nbr, 701, 100)
    halo_spmm(n, w, _t(data), _t(scale), wl_ids=_t(wl.ids),
              wl_cnt=_t(wl.cnt), backend="pallas_skip", chunk_rows=100)
    tab = _t(table).requires_grad_()
    wg = w.clone().requires_grad_()
    spmm(n, wg, tab).sum().backward()
    assert tab.grad is not None and wg.grad is not None
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gat_edge import gat_edge_partial_cuda
    q = torch.from_numpy(rng.normal(size=(2, 70, 16)).astype(np.float32))
    flash_attention_cuda(q, q[:1], q[:1])
    gat_edge_partial_cuda(n, n < 700, w[:, 0].contiguous(),
                          _t(table[:, 0].copy()), _t(table))
    assert set(_build.LAUNCHES) == {
        "spmm", "halo_spmm", "halo_spmm_stream", "halo_spmm_skip",
        "spmm_bwd_table", "spmm_bwd_wts", "flash_attention",
        "gat_edge_partial"}
    assert all(v == 0 for v in _build.LAUNCHES.values()), _build.LAUNCHES


def test_wrappers_check_inputs():
    n = torch.zeros((4, 2), dtype=torch.int32)
    w = torch.zeros((4, 2))
    with pytest.raises(TypeError):
        spmm_cuda(n.long(), w, torch.zeros((3, 8)))
    with pytest.raises(ValueError):
        spmm_cuda(n, w[:, :1], torch.zeros((3, 8)))
    with pytest.raises(ValueError):
        spmm_cuda(n, w, torch.zeros((8, 3)).t())
    with pytest.raises(ValueError):
        halo_spmm_cuda(n, w, torch.zeros((3, 8), dtype=torch.int8),
                       torch.ones((3,)))
    with pytest.raises(ValueError):
        halo_spmm_stream_cuda(n, w, torch.zeros((3, 8)), chunk_rows=0)
