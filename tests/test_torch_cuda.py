"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: skipped where no card is present.  This file
imports neither JAX nor the reference package, so it also runs where only
the port is installed:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance 1e-5 (atol = rtol): the kernels fuse each multiply-add (FMA),
the plain versions round the product first; the order over k is the same.
K5 and K6 are held to the reference's own kernel bars (K5: 1e-4 on acc,
1e-5 on l, and m bit for bit, a max of identically computed values; K6:
2e-5 in fp32, and in bf16 that plus one bf16 ulp of the output, since
both sides compute in fp32 and round once).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.core.halo_exchange import HaloPrecision, quantize_rows
from repro_torch.graph import build_chunk_worklist
from repro_torch.graph.transpose import ell_transpose
from repro_torch.kernels import _build
from repro_torch.kernels.spmm import (halo_spmm, halo_spmm_cuda,
                                      halo_spmm_plain, halo_spmm_skip_cuda,
                                      halo_spmm_skip_plain,
                                      halo_spmm_stream_cuda,
                                      halo_spmm_stream_plain,
                                      halo_spmm_stream_walk_cuda,
                                      spmm_bwd_table,
                                      spmm_bwd_table_plain, spmm_bwd_wts,
                                      spmm_bwd_wts_plain, spmm_cuda,
                                      spmm_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain,
                                                 multi_head_attention)
from repro_torch.kernels.gat_edge import (gat_aggregate,
                                          gat_edge_partial_cuda,
                                          gat_edge_partial_plain)
from repro_torch.launch.serving_driver import profile_serve_loop
from torch_gat_cases import INF_ROW, NAN_ROW, NO_VALID, bits, edge_case

pytestmark = pytest.mark.cuda
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _case(seed, rows, deg, ncols, feat, dev):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, ncols + 1, size=(rows, deg)).astype(np.int32)
    wts = (rng.random((rows, deg)) * (nbr < ncols)).astype(np.float32)
    table = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    table[-1] = 0
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(wts).to(dev),
            torch.from_numpy(table).to(dev))


def _slab(table, storage):
    data, scale = quantize_rows(table, HaloPrecision(storage))
    data[-1] = 0
    return data, scale


def _table_as(table, dtype):
    """The fp32 test table in a storage dtype (int8: codes of an int8
    store, up to 127 in magnitude; the zero sentinel row stays zero)."""
    if dtype == torch.int8:
        return (table * 30).round().clamp(-127, 127).to(torch.int8)
    return table.to(dtype)


def _assert_spmm_close(got, nbr, wts, table):
    """K1 against its plain version within 1e-5 (atol = rtol).  For int8
    codes the relative part is taken of the sum of |terms| instead of
    |sum|: a code's product with a weight is up to 127 times an fp32
    table's, and the plain version rounds each product before it adds it
    while the kernel fuses it, so a cancelling sum of 80 such terms
    differs by more than 1e-5 of its result (measured: 6.6e-5)."""
    want = spmm_plain(nbr, wts, table)
    if table.dtype != torch.int8:
        torch.testing.assert_close(got, want, **TOL)
        return
    mag = spmm_plain(nbr, wts.abs(), table.float().abs())
    err = (got - want).abs()
    assert bool((err <= 1e-5 + 1e-5 * mag).all()), float(err.max())


@pytest.mark.parametrize("rows,deg,ncols,feat", [
    (17, 3, 9, 33), (384, 9, 57, 70), (1000, 80, 12000, 128),
    (300, 5, 40, 300), (3000, 12, 400, 32), (2000, 9, 700, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_spmm_kernel(dev, rows, deg, ncols, feat, dtype):
    nbr, wts, table = _case(rows, rows, deg, ncols, feat, dev)
    table = _table_as(table, dtype)
    before = _build.LAUNCHES["spmm"]
    got = spmm_cuda(nbr, wts, table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmm"] == before + 1
    _assert_spmm_close(got, nbr, wts, table)


def _padded_case(seed, rows, deg, ncols, feat, live, layout, dev):
    """An ELL whose rows hold 0 .. 2 * live real edges (at most deg; mean
    about ``live``) and pad the rest with weight 0 on the sentinel row
    ``ncols``: the padding ``scattered`` through the row, ``trailing``, or
    every slot padding (``empty``).  Returns nbr, wts, the table (zero
    sentinel row) and each row's real-edge count."""
    rng = np.random.default_rng(seed)
    n = np.minimum(rng.integers(0, 2 * live + 1, size=rows), deg)
    if layout == "empty":
        n[:] = 0
    if layout == "scattered":
        rank = np.argsort(np.argsort(rng.random((rows, deg)), axis=1),
                          axis=1)
    else:
        rank = np.broadcast_to(np.arange(deg), (rows, deg))
    real = rank < n[:, None]
    nbr = np.where(real, rng.integers(0, ncols, size=(rows, deg)),
                   ncols).astype(np.int32)
    wts = np.where(real, rng.random((rows, deg)) + 0.1, 0).astype(np.float32)
    table = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    table[-1] = 0
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(wts).to(dev),
            torch.from_numpy(table).to(dev), torch.from_numpy(n).to(dev))


@pytest.mark.parametrize("layout", ["scattered", "trailing", "empty"])
@pytest.mark.parametrize("rows,deg,ncols,live", [
    (256, 80, 12615, 69),       # the serving query batch
    (5256, 56, 5256, 3),        # the training in-ELL, three real edges
    (300, 40, 900, 20),         # two segments
    (200, 150, 3000, 60),       # past the four segments held in registers
    (120, 300, 3000, 140)])     # ten segments, most re-read
@pytest.mark.parametrize("feat", [32, 33, 100, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_spmm_kernel_skips_padding(dev, layout, rows, deg, ncols, live, feat,
                                   dtype):
    """K1 on ELLs mostly padding (the slots it skips), wherever the padding
    lies, over both launch layouts (few rows: warps split a row's
    stripes; many: a warp a row): against its plain version, rows with no
    real edge exactly 0, equal to itself across calls."""
    nbr, wts, table, n = _padded_case(rows * feat + deg, rows, deg, ncols,
                                      feat, live, layout, dev)
    table = _table_as(table, dtype)
    before = _build.LAUNCHES["spmm"]
    got = spmm_cuda(nbr, wts, table)
    again = spmm_cuda(nbr, wts, table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmm"] == before + 2
    assert torch.equal(got, again)
    _assert_spmm_close(got, nbr, wts, table)
    assert torch.equal(got[n == 0], torch.zeros_like(got[n == 0]))


@pytest.mark.parametrize("feat", [33, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_spmm_kernel_layouts_agree(dev, feat, dtype):
    """The first 256 rows alone (warps splitting each row's stripes) give
    the same bits as those rows of a 4000-row launch (a warp a row): each
    element keeps its FMA chain."""
    nbr, wts, table, _ = _padded_case(7, 4000, 80, 12615, feat, 40,
                                      "scattered", dev)
    table = _table_as(table, dtype)
    whole = spmm_cuda(nbr, wts, table)
    part = spmm_cuda(nbr[:256].contiguous(), wts[:256].contiguous(), table)
    assert torch.equal(part, whole[:256])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [64, 3000])
def test_spmm_kernel_zero_weights_on_real_rows(dev, dtype, rows):
    """Only a zero weight on the sentinel is skipped: zero weights on real
    rows stay, so 0 * inf is NaN exactly where the plain version has NaN;
    a finite nonzero sentinel row changes nothing for its zero-weight
    slots and counts for its nonzero ones."""
    nbr, wts, table, _ = _padded_case(rows, rows, 40, 500, 64, 10,
                                      "scattered", dev)
    table[-1] = torch.linspace(-2, 2, table.shape[1], device=dev)
    table[5, 3] = float("inf")
    wts[wts.shape[0] // 3:, 5] = 0          # zero weights on real rows
    nbr[:3][nbr[:3] == 5] = 6               # row 5 only where set below
    nbr[0, 1], wts[0, 1] = 5, 0.0           # 0 * inf
    nbr[1, 0], wts[1, 0] = 5, 0.5           # 0.5 * inf
    nbr[2, 3], wts[2, 3] = 500, 0.25        # a weight on the sentinel
    table = table.to(dtype)
    got = spmm_cuda(nbr, wts, table)
    want = spmm_plain(nbr, wts, table)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0, 3])) and bool(torch.isinf(got[1, 3]))
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    torch.testing.assert_close(got, want, equal_nan=True, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [256, 3000])
def test_k3_over_one_chunk_equals_k1(dev, dtype, rows):
    """K3 over one chunk on an unscaled slab takes K1's FMAs (K3 keeps the
    padding terms, each + 0): equal bit for bit, as chip_smoke.py holds at
    the query shape."""
    nbr, wts, table, _ = _padded_case(rows + 1, rows, 80, 12615, 128, 60,
                                      "scattered", dev)
    table = table.to(dtype)
    k1 = spmm_cuda(nbr, wts, table)
    one = halo_spmm_stream_cuda(nbr, wts, table, chunk_rows=table.shape[0])
    assert torch.equal(one, k1)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("shape", [(17, 3, 9, 33), (256, 80, 12615, 128)])
def test_halo_kernels(dev, storage, pred, shape):
    rows, deg, ncols, feat = shape
    nbr, wts, table = _case(7 + rows, rows, deg, ncols, feat, dev)
    data, scale = _slab(table, storage)
    if scale is None:
        scale = torch.ones((data.shape[0], 1), device=dev)  # reach K2
    pdata = pscale = None
    if pred:
        pdata, pscale = _slab(torch.randn_like(table), storage)
    args = (nbr, wts, data, scale, pdata, pscale, 0.7)
    k2 = halo_spmm_cuda(*args)
    torch.testing.assert_close(k2, halo_spmm_plain(*args), **TOL)
    chunk = 512 if ncols > 512 else 4
    k3 = halo_spmm_stream_cuda(*args, chunk_rows=chunk)
    torch.testing.assert_close(
        k3, halo_spmm_stream_plain(*args, chunk_rows=chunk), **TOL)
    torch.testing.assert_close(k3, k2, **TOL)
    # One chunk covering the slab: the very same FMAs as K2.
    one = halo_spmm_stream_cuda(*args, chunk_rows=data.shape[0])
    assert torch.equal(one, k2)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("shape", [
    (150, 200, 3000, 33, 64),     # past the register segments, scalar
    (140, 20, 500, 9, 64),        # feat < 32: lanes past feat idle
    (100, 40, 2000, 300, 64),     # feat > 128: three vector stripes
    (64, 24, 299, 64, 1),         # chunk_rows 1: every slot a chunk
    (256, 80, 12615, 128, 512)])  # the serving query batch's shape
def test_halo_row_bodies(dev, storage, pred, shape):
    """K2's and K3's warp-per-row bodies on unsorted rows (a row's chunks
    interleave in k): each against its plain version, equal to itself
    across calls; K3's edge list equal to its chunk walk, K3 over one
    chunk to K2, and K4 on the row blocks' own worklists to K3, all bit
    for bit."""
    rows, deg, ncols, feat, chunk = shape
    nbr, wts, table = _case(51 + deg, rows, deg, ncols, feat, dev)
    data, scale = _slab(table, storage)
    if scale is None:
        scale = torch.ones((data.shape[0], 1), device=dev)  # reach K2
    pdata = pscale = None
    if pred:
        pdata, pscale = _slab(torch.randn_like(table), storage)
    args = (nbr, wts, data, scale, pdata, pscale, 0.7)
    before = dict(_build.LAUNCHES)
    k2 = halo_spmm_cuda(*args)
    k3 = halo_spmm_stream_cuda(*args, chunk_rows=chunk)
    walk = halo_spmm_stream_walk_cuda(*args, chunk_rows=chunk)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["halo_spmm"] == before["halo_spmm"] + 1
    assert (_build.LAUNCHES["halo_spmm_stream"]
            == before["halo_spmm_stream"] + 2)
    assert torch.equal(k2, halo_spmm_cuda(*args))
    assert torch.equal(k3, halo_spmm_stream_cuda(*args, chunk_rows=chunk))
    torch.testing.assert_close(k2, halo_spmm_plain(*args), **TOL)
    torch.testing.assert_close(
        k3, halo_spmm_stream_plain(*args, chunk_rows=chunk), **TOL)
    assert torch.equal(walk, k3)
    one = halo_spmm_stream_cuda(*args, chunk_rows=data.shape[0])
    assert torch.equal(one, k2)
    wl = build_chunk_worklist(nbr.cpu().numpy(), data.shape[0], chunk)
    k4 = halo_spmm_skip_cuda(nbr, wts, data, scale,
                             torch.from_numpy(wl.ids).to(dev),
                             torch.from_numpy(wl.cnt).to(dev), pdata,
                             pscale, 0.7, chunk_rows=chunk)
    assert torch.equal(k4, k3)


@pytest.mark.parametrize("storage", ["fp32", "int8"])
@pytest.mark.parametrize("deg", [2800, 3400])
def test_halo_long_rows(dev, storage, deg):
    """Long rows: 2800 edges take one row a block and 56 KB of shared
    memory (past the 48 KB default), 3400 (68 KB) go to the chunk walk.
    Against the plain version, equal to the walk, and K3 over one chunk
    equal to K2.  The rounding of a sum of thousands of terms scales with
    the sum of |terms|, not with the result, which cancels: the kernel's
    fused and the plain version's rounded products are held within 1e-5
    of the sum of |terms| (a dropped edge moves a result by ~0.4, that bar
    by ~0.01)."""
    nbr, wts, table = _case(61, 6, deg, 100, 40, dev)
    data, scale = _slab(table, storage)
    args = (nbr, wts, data, scale, None, None, 1.0)
    k3 = halo_spmm_stream_cuda(*args, chunk_rows=32)
    want = halo_spmm_stream_plain(*args, chunk_rows=32)
    mag = halo_spmm_plain(nbr, wts.abs(), data.abs(), scale)
    assert bool(((k3 - want).abs() <= 1e-5 * mag).all())
    assert torch.equal(k3, halo_spmm_stream_walk_cuda(*args, chunk_rows=32))
    if scale is not None:
        assert torch.equal(halo_spmm_stream_cuda(*args, chunk_rows=101),
                           halo_spmm_cuda(*args))


def test_ladder_launches_the_selected_kernel(dev):
    nbr, wts, table = _case(3, 64, 8, 3000, 128, dev)
    data, scale = _slab(table, "int8")
    _build.reset_launches()
    halo_spmm(nbr, wts, data, scale)                         # resident
    halo_spmm(nbr, wts, table)                               # K1 delegate
    halo_spmm(nbr, wts, table, resident_max_bytes=1024)      # stream
    wl = build_chunk_worklist(nbr.cpu().numpy(), table.shape[0], 512)
    halo_spmm(nbr, wts, table, wl_ids=torch.from_numpy(wl.ids).to(dev),
              wl_cnt=torch.from_numpy(wl.cnt).to(dev),
              resident_max_bytes=1024, occupancy=wl.occupancy,
              skip_occupancy_max=1.0)                        # skip
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {"spmm": 1, "halo_spmm": 1,
                               "halo_spmm_stream": 1, "halo_spmm_skip": 1,
                               "spmm_bwd_table": 0, "spmm_bwd_wts": 0,
                               "flash_attention": 0, "gat_edge_partial": 0}


def test_profile_serve_loop_splits_device_time(dev):
    nbr, wts, table = _case(9, 256, 80, 12000, 128, dev)

    def step(carry, _):
        return carry + 1, spmm_cuda(nbr, wts, table)

    split = profile_serve_loop(step, range(4), carry=0)
    assert 0 < split["device_ms"] <= split["wall_ms"]
    assert 0 < split["busy_share"] <= 1
    assert any("spmm_kernel" in op["op"] for op in split["top"])


def test_kernels_refuse_bad_inputs(dev):
    nbr, wts, table = _case(5, 8, 2, 4, 16, dev)
    with pytest.raises(ValueError):
        spmm_cuda(nbr, wts, table.cpu())
    with pytest.raises(TypeError):
        spmm_cuda(nbr, wts, table.double())


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [(17, 3, 9, 33), (300, 64, 14288, 128)])
def test_skip_kernel(dev, storage, shape):
    """K4 against its plain version, bit for bit equal to K3 at equal
    chunk_rows, visiting exactly its worklist."""
    rows, deg, ncols, feat = shape
    nbr, wts, table = _case(11 + rows, rows, deg, ncols, feat, dev)
    nbr = torch.sort(nbr, dim=0).values     # clustered: blocks skip chunks
    data, scale = _slab(table, storage)
    chunk = 256 if ncols > 256 else 4
    wl = build_chunk_worklist(nbr.cpu().numpy(), data.shape[0], chunk)
    ids = torch.from_numpy(wl.ids).to(dev)
    cnt = torch.from_numpy(wl.cnt).to(dev)
    args = (nbr, wts, data, scale, ids, cnt)
    k4, visits = halo_spmm_skip_cuda(*args, chunk_rows=chunk,
                                     count_visits=True)
    torch.testing.assert_close(
        k4, halo_spmm_skip_plain(*args, chunk_rows=chunk), **TOL)
    k3 = halo_spmm_stream_cuda(nbr, wts, data, scale, chunk_rows=chunk)
    assert torch.equal(k4, k3)
    t = torch.arange(wl.max_chunks, device=dev)[None, :]
    assert torch.equal(visits, torch.where(t < cnt[:, None], ids, -1))


def _skip_case(seed, rows, deg, ncols, feat, storage, pred, dev):
    """A clustered ELL (sorted per column, so row blocks skip chunks) over
    a quantised slab, optionally with a SAT predictor slab, and its
    worklist at 64-row chunks."""
    nbr, wts, table = _case(seed, rows, deg, ncols, feat, dev)
    nbr = torch.sort(nbr, dim=0).values
    data, scale = _slab(table, storage)
    pdata = pscale = None
    if pred:
        pdata, pscale = _slab(torch.randn_like(table), storage)
    wl = build_chunk_worklist(nbr.cpu().numpy(), data.shape[0], 64)
    return (nbr, wts, data, scale, pdata, pscale), wl


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("shape", [
    (300, 64, 2000, 128),      # two ballot segments, vector gathers
    (200, 100, 3000, 64),      # four segments, all held in registers
    (150, 200, 3000, 33),      # segments past the register cache, scalar
    (140, 20, 500, 9)])        # feat < 32: lanes past feat idle
def test_skip_kernel_one_pass(dev, storage, pred, shape):
    """K4's warp-per-row body: with the SAT predictor terms, degrees past
    two ballot segments and past the register cache, and feat not a
    multiple of 4 — against its plain version, equal to K3 bit for bit,
    and equal to itself across calls."""
    rows, deg, ncols, feat = shape
    (nbr, wts, data, scale, pdata, pscale), wl = _skip_case(
        31 + deg, rows, deg, ncols, feat, storage, pred, dev)
    ids = torch.from_numpy(wl.ids).to(dev)
    cnt = torch.from_numpy(wl.cnt).to(dev)
    kw = dict(pdata=pdata, pscale=pscale, gamma=0.7, chunk_rows=64)
    args = (nbr, wts, data, scale, ids, cnt)
    before = _build.LAUNCHES["halo_spmm_skip"]
    k4 = halo_spmm_skip_cuda(*args, **kw)
    again = halo_spmm_skip_cuda(*args, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["halo_spmm_skip"] == before + 2
    assert torch.equal(k4, again)
    torch.testing.assert_close(k4, halo_spmm_skip_plain(*args, **kw), **TOL)
    k3 = halo_spmm_stream_cuda(nbr, wts, data, scale, pdata, pscale, 0.7,
                               chunk_rows=64)
    assert torch.equal(k4, k3)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
def test_skip_kernel_truncated_worklist(dev, storage):
    """Chunks dropped from the worklists drop their edges, as in the plain
    version: K4 then differs from K3 in the truncated blocks only."""
    (nbr, wts, data, scale, pdata, pscale), wl = _skip_case(
        41, 384, 72, 2000, 128, storage, True, dev)
    cnt = wl.cnt.copy()
    cnt[0] -= 1
    cnt[2] = 0
    ids = torch.from_numpy(wl.ids).to(dev)
    cnt = torch.from_numpy(cnt).to(dev)
    kw = dict(pdata=pdata, pscale=pscale, gamma=0.7, chunk_rows=64)
    args = (nbr, wts, data, scale, ids, cnt)
    k4, visits = halo_spmm_skip_cuda(*args, count_visits=True, **kw)
    torch.testing.assert_close(k4, halo_spmm_skip_plain(*args, **kw), **TOL)
    assert torch.equal(k4, halo_spmm_skip_cuda(*args, **kw))
    k3 = halo_spmm_stream_cuda(nbr, wts, data, scale, pdata, pscale, 0.7,
                               chunk_rows=64)
    assert not torch.allclose(k4[:128], k3[:128])
    assert torch.equal(k4[128:256], k3[128:256])
    assert not bool(k4[256:].any())
    t = torch.arange(wl.max_chunks, device=dev)[None, :]
    assert torch.equal(visits, torch.where(t < cnt[:, None], ids, -1))


@pytest.mark.parametrize("rows,deg,ncols,feat", [
    (17, 3, 16, 33), (384, 9, 383, 70), (5256, 56, 5256, 128)])
def test_backward_kernels(dev, rows, deg, ncols, feat):
    nbr, wts, table = _case(21 + rows, rows, deg, ncols, feat, dev)
    g = torch.randn((rows, feat), device=dev)
    pos = torch.from_numpy(ell_transpose(nbr.cpu().numpy(), ncols + 1)
                           ).to(dev)
    before = dict(_build.LAUNCHES)
    dtab = spmm_bwd_table(pos, wts, g)
    dw = spmm_bwd_wts(nbr, g, table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmm_bwd_table"] == before["spmm_bwd_table"] + 1
    assert _build.LAUNCHES["spmm_bwd_wts"] == before["spmm_bwd_wts"] + 1
    torch.testing.assert_close(dtab, spmm_bwd_table_plain(pos, wts, g),
                               **TOL)
    torch.testing.assert_close(dw, spmm_bwd_wts_plain(nbr, g, table), **TOL)
    # Through autograd: the Function's backward launches both kernels.
    w = wts.clone().requires_grad_()
    t = table.clone().requires_grad_()
    spmm_cuda(nbr, w, t, pos).backward(g)
    assert torch.equal(w.grad, dw) and torch.equal(t.grad, dtab)


@pytest.mark.parametrize("hub", [0, 40, 200])
@pytest.mark.parametrize("feat", [32, 33, 128])
@pytest.mark.parametrize("rows", [256, 5256])
def test_backward_table_kernel_segments(dev, hub, feat, rows):
    """The table gradient's warp-per-row body: table row 0 is a hub with
    ``hub`` more positions (t_deg past one and past four 32-position
    segments), most rows one to three positions, many rows none (all
    padding), at w32/w33/w128 over both launch layouts: against its plain
    version, padding rows and the sentinel row exactly 0, equal to itself
    and to the autograd backward."""
    ncols = 2 * rows            # about 1.5 positions a table row
    nbr, wts, table, _ = _padded_case(hub + rows, rows, 56, ncols, feat, 3,
                                      "trailing", dev)
    nbr[:hub, -1], wts[:hub, -1] = 0, 0.75       # the hub's positions
    pos = torch.from_numpy(ell_transpose(nbr.cpu().numpy(), ncols + 1)
                           ).to(dev)
    g = torch.randn((rows, feat), device=dev)
    before = _build.LAUNCHES["spmm_bwd_table"]
    dtab = spmm_bwd_table(pos, wts, g)
    again = spmm_bwd_table(pos, wts, g)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmm_bwd_table"] == before + 2
    assert torch.equal(dtab, again)
    torch.testing.assert_close(dtab, spmm_bwd_table_plain(pos, wts, g),
                               **TOL)
    empty = (pos >= nbr.numel()).all(dim=1)
    assert bool(empty[-1]) and int(empty.sum()) > rows // 4
    assert torch.equal(dtab[empty], torch.zeros_like(dtab[empty]))
    t = table.clone().requires_grad_()
    spmm_cuda(nbr, wts, t, pos).backward(g)
    assert torch.equal(t.grad, dtab)


def _wts_case(seed, rows, deg, ncols, feat, sentinel, dev):
    """A weight-gradient case: row 0 every slot live (no sentinel), row 1
    every slot the sentinel ``ncols``, row 2 live on its first ``deg -
    10`` slots and the sentinel after (past 128 slots at deg 200: the
    sentinel first met in a later round), row 3 the sentinel at slots 5
    and ``deg - 1`` only, the rest about three live slots scattered among
    sentinel slots.  The sentinel row of the fp32 table is ``zero``,
    ``nonzero`` or ``nan``."""
    rng = np.random.default_rng(seed)
    live = rng.random((rows, deg)) < 3.0 / deg
    live[0], live[1] = True, False
    live[2] = np.arange(deg) < deg - 10
    live[3] = True
    live[3, [5, deg - 1]] = False
    nbr = np.where(live, rng.integers(0, ncols, size=(rows, deg)),
                   ncols).astype(np.int32)
    table = rng.normal(size=(ncols + 1, feat)).astype(np.float32)
    table[-1] = (rng.normal(size=feat) if sentinel == "nonzero"
                 else {"zero": 0.0, "nan": np.nan}[sentinel])
    g = rng.normal(size=(rows, feat)).astype(np.float32)
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(g).to(dev),
            torch.from_numpy(table).to(dev))


@pytest.mark.parametrize("dtype,sentinel", [
    (torch.float32, "zero"), (torch.float32, "nonzero"),
    (torch.float32, "nan"), (torch.bfloat16, "zero"),
    (torch.bfloat16, "nonzero"), (torch.bfloat16, "nan"),
    (torch.int8, "zero"), (torch.int8, "nonzero")])
@pytest.mark.parametrize("feat", [8, 32, 33, 128])
@pytest.mark.parametrize("deg", [40, 56, 200])
def test_backward_wts_kernel(dev, dtype, sentinel, feat, deg):
    """The weight gradient's warp-per-row body: rows with every slot
    live, every slot the sentinel, the sentinel met only in a later
    128-slot round, and scattered live slots, at deg past 32 and past 128,
    w8/w32/w128 (vector lanes) and w33 (single elements), fp32, bf16 and
    int8 tables with a zero, nonzero or NaN sentinel row: against its
    plain version (NaN where it is NaN), every sentinel slot of a row one
    value, equal to itself across calls."""
    rows = 300
    nbr, g, table = _wts_case(deg + feat, rows, deg, 500, feat, sentinel,
                              dev)
    table = _table_as(table, dtype) if sentinel != "nan" else table.to(dtype)
    before = _build.LAUNCHES["spmm_bwd_wts"]
    got = spmm_bwd_wts(nbr, g, table)
    again = spmm_bwd_wts(nbr, g, table)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["spmm_bwd_wts"] == before + 2
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    assert torch.equal(got.isnan(), again.isnan())
    want = spmm_bwd_wts_plain(nbr, g, table)
    if dtype == torch.int8:
        # As for K1 (_assert_spmm_close): int8 codes up to 127, so the
        # relative part is taken of the sum of |terms|.
        mag = spmm_bwd_wts_plain(nbr, g.abs(), table.float().abs())
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * mag).all()), float(err.max())
    else:
        torch.testing.assert_close(got, want, equal_nan=True, **TOL)
    # Every sentinel slot of a row holds the value of its first one.
    sent = nbr == table.shape[0] - 1
    assert bool(sent[1].all()) and not bool(sent[0].any())
    first = got.gather(1, sent.int().argmax(1, keepdim=True))
    same = (got == first) | (got.isnan() & first.isnan())
    assert bool((same | ~sent).all())


def test_halo_kernels_refuse_grad_on_the_card(dev):
    nbr, wts, table = _case(6, 8, 2, 40, 16, dev)
    data, scale = _slab(table, "int8")
    with pytest.raises(RuntimeError, match="no backward"):
        halo_spmm_cuda(nbr, wts.clone().requires_grad_(), data, scale)
    with pytest.raises(RuntimeError, match="no backward"):
        halo_spmm_stream_cuda(nbr, wts, table.clone().requires_grad_(),
                              scale)


def _bf16_bar(w):
    e = torch.floor(torch.log2(w.float().abs().clamp_min(2.0 ** -126)))
    return 2e-5 + torch.exp2(e - 7)


@pytest.mark.parametrize("b,s,h,kv,d", [
    (1, 1, 1, 1, 16), (2, 100, 4, 2, 32), (1, 256, 8, 8, 64),
    (2, 130, 6, 2, 96), (2, 512, 16, 8, 128), (2, 200, 16, 2, 112),
    (1, 300, 40, 8, 128), (1, 130, 10, 2, 112)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(dev, b, s, h, kv, d, dtype, causal):
    """K6 on (B, H, S, D) views of (B, S, H, D) tensors (the transformer's
    layout) against its plain version, equal bit for bit to the same
    call on contiguous 3-D tensors with K/V rows bh // rep; kimi-k2's head
    dim 112 and llama4-scout's five query heads a KV head (the bf16
    body's one-warpgroup blocks), alone and together."""
    gen = torch.Generator().manual_seed(b * s + d)
    q = torch.randn((b, s, h, d), generator=gen).to(dev, dtype)
    k = torch.randn((b, s, kv, d), generator=gen).to(dev, dtype)
    v = torch.randn((b, s, kv, d), generator=gen).to(dev, dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    before = _build.LAUNCHES["flash_attention"]
    got = flash_attention_cuda(qt, kt, vt, causal)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.transpose(1, 2).is_contiguous()
    want = flash_attention_plain(qt, kt, vt, causal)
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    else:
        assert bool((err <= _bf16_bar(want)).all()), float(err.max())
    flat = flash_attention_cuda(*(t.contiguous().reshape(-1, s, d)
                                  for t in (qt, kt, vt)), causal)
    assert torch.equal(flat.reshape(b, h, s, d), got)
    mha = multi_head_attention(q, k, v, causal, backend="auto")
    assert torch.equal(mha, got.transpose(1, 2))


@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128])
@pytest.mark.parametrize("s", [64, 200, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_tensor_cores(dev, d, s, causal):
    """K6's bf16 path (wgmma on TMA-fed tiles) at every head dim, ragged
    and whole tiles, with two query heads a KV head (two warpgroups a
    block) and with three (one): within the bar of its plain version, and
    bit-identical across calls."""
    for b, h, kv in ((2, 4, 2), (1, 3, 1)):
        gen = torch.Generator().manual_seed(s * d + h)
        q = torch.randn((b, s, h, d), generator=gen).to(dev, torch.bfloat16)
        k = torch.randn((b, s, kv, d), generator=gen).to(dev, torch.bfloat16)
        v = torch.randn((b, s, kv, d), generator=gen).to(dev, torch.bfloat16)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        got = flash_attention_cuda(qt, kt, vt, causal)
        again = flash_attention_cuda(qt, kt, vt, causal)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        want = flash_attention_plain(qt, kt, vt, causal)
        err = (got.float() - want.float()).abs()
        assert bool((err <= _bf16_bar(want)).all()), (b, h, kv,
                                                      float(err.max()))


@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128])
@pytest.mark.parametrize("s", [1, 63, 65, 1000])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fp32_body(dev, d, s, causal):
    """K6's fp32 body (128-row Q tiles, cp.async-fed micro-tiles) at every
    head dim, one key, ragged tiles either side of 64 and a long ragged
    sequence, with one, two and four query heads a KV head: on (B, H, S,
    D) views of (B, S, H, D) tensors against its plain version within 2e-5
    (atol = rtol), equal bit for bit to the same call on flat 3-D tensors
    and to a second call."""
    for b, h, kv in ((2, 3, 3), (1, 4, 2), (2, 8, 2)):
        gen = torch.Generator().manual_seed(s * d + h)
        q = torch.randn((b, s, h, d), generator=gen).to(dev)
        k = torch.randn((b, s, kv, d), generator=gen).to(dev)
        v = torch.randn((b, s, kv, d), generator=gen).to(dev)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        before = _build.LAUNCHES["flash_attention"]
        got = flash_attention_cuda(qt, kt, vt, causal)
        again = flash_attention_cuda(qt, kt, vt, causal)
        flat = flash_attention_cuda(*(t.contiguous().reshape(-1, s, d)
                                      for t in (qt, kt, vt)), causal)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["flash_attention"] == before + 3
        assert torch.equal(got, again)
        assert torch.equal(flat.reshape(b, h, s, d), got)
        want = flash_attention_plain(qt, kt, vt, causal)
        torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("d", [16, 32, 64, 96, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_fp32_unaligned_views(dev, d, causal):
    """Strided fp32 views that 16-byte copies cannot read (a base one
    float past a 16-byte boundary, odd row strides) take the fp32 body's
    4-byte copies: within 2e-5 of the plain version and equal bit for bit
    to the same call on aligned copies of the inputs."""
    b, s, h, kv = 2, 130, 3, 1
    gen = torch.Generator().manual_seed(d)

    def odd(heads):
        # (B, S, heads, D + 1) one float into a buffer, cut to D: base
        # offset 4 bytes, odd strides heads * (D + 1) over S and D + 1
        # over the heads.
        n = b * s * heads * (d + 1)
        buf = torch.randn((n + 1,), generator=gen).to(dev)
        x = buf[1:].view(b, s, heads, d + 1)[..., :d].transpose(1, 2)
        assert x.data_ptr() % 16 and x.stride(2) % 4
        return x

    qt, kt, vt = odd(h), odd(kv), odd(kv)
    got = flash_attention_cuda(qt, kt, vt, causal)
    aligned = flash_attention_cuda(qt.contiguous(), kt.contiguous(),
                                   vt.contiguous(), causal)
    torch.cuda.synchronize()
    assert torch.equal(got, aligned)
    want = flash_attention_plain(qt, kt, vt, causal)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def _check_k5(args):
    """K5 on the card against its plain version: m bit for bit (a max of
    identically computed values), acc within 1e-4 and l within 1e-5 (the
    reference's bars), NaN in the same places; a second launch equal bit
    for bit; one launch counted a call."""
    before = _build.LAUNCHES["gat_edge_partial"]
    got = gat_edge_partial_cuda(*args)
    again = gat_edge_partial_cuda(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["gat_edge_partial"] == before + 2
    want = gat_edge_partial_plain(*args)
    for g, a in zip(got, again):
        assert torch.equal(bits(g), bits(a))
    assert torch.equal(bits(got[1]), bits(want[1]))
    for g, w, tol in ((got[0], want[0], 1e-4), (got[2], want[2], 1e-5)):
        torch.testing.assert_close(g, w, atol=tol, rtol=tol, equal_nan=True)
    return got


@pytest.mark.parametrize("kind,rows,deg,ncols,feat", [
    ("masked", 17, 3, 9, 33), ("masked", 128, 8, 64, 128),
    ("masked", 5256, 64, 14288, 32), ("padded", 5256, 56, 5256, 32),
    ("padded", 5256, 64, 14288, 32), ("padded", 40, 5, 30, 0)])
def test_gat_edge_kernel(dev, kind, rows, deg, ncols, feat):
    """K5 at ragged shapes, the reference's width-128 test shape, GAT's
    per-head shapes on the papers-sim partition (in-ELL 5256 x 56 over
    5257 rows, out-ELL 5256 x 64 over 14289, width 32, rows padded to the
    sentinel as the main path's are) and zero features (m and l are still
    computed); then ``gat_aggregate``, K5 once per edge set."""
    args = [torch.from_numpy(a).to(dev) for a in
            edge_case(kind, deg, rows, ncols, feat, seed=rows + deg)]
    acc, m, l = _check_k5(args)
    assert acc.shape == (rows, feat) and bool(torch.isfinite(acc).all())
    assert bool((m[6:] > -1e30).any())
    before = _build.LAUNCHES["gat_edge_partial"]
    agg = gat_aggregate(args[0], args[1], args[0], args[1], *args[2:4],
                        *args[3:5], args[4])
    assert _build.LAUNCHES["gat_edge_partial"] == before + 2
    assert bool(torch.isfinite(agg).all())


@pytest.mark.parametrize("kind", ["masked", "nan_score", "inf_z", "padded"])
@pytest.mark.parametrize("deg", [0, 1, 31, 32, 33, 129, 300])
@pytest.mark.parametrize("feat", [1, 8, 32, 33, 128, 256])
def test_gat_edge_kernel_cases(dev, kind, deg, feat):
    """K5's warp-per-row body over 32-slot groups and 128-slot segments
    (deg 31-33, 129, 300), one to eight 32-feature stripes (feat 1-256),
    rows with no or only late valid slots, a NaN score at a valid slot (m
    NaN, as torch.maximum gives: the body's max must carry NaN) and an
    Inf / NaN z row behind an invalid slot (acc NaN where the plain
    version has it: no slot may be skipped)."""
    args = [torch.from_numpy(a).to(dev) for a in
            edge_case(kind, deg, 70, 50, feat, seed=deg * 7 + feat)]
    acc, m, l = _check_k5(args)
    if deg:
        assert bool((m[NO_VALID:NO_VALID + 3] == -1e30).all())
        assert bool((l[NO_VALID:NO_VALID + 3] == deg).all())
    else:
        assert bool((m == -1e30).all()) and not bool(l.any())
        assert not bool(acc.any())
    if deg and kind == "nan_score":
        assert bool(m[NAN_ROW].isnan()) and bool(l[NAN_ROW].isnan())
    if deg and kind == "inf_z" and feat > 2:
        assert bool(acc[INF_ROW].isnan().any())


def test_new_kernels_refuse_bad_inputs(dev):
    q = torch.randn((2, 8, 16), device=dev)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q.cpu(), q)
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(*(torch.randn((2, 8, 48), device=dev),) * 3)
    nbr = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    valid = torch.ones((4, 2), dtype=torch.bool, device=dev)
    s_dst = torch.zeros(4, device=dev)
    s_src = torch.zeros(3, device=dev)
    z = torch.zeros((3, 8), device=dev)
    with pytest.raises(ValueError):
        gat_edge_partial_cuda(nbr, valid, s_dst, s_src, z.cpu())
    with pytest.raises(TypeError):
        gat_edge_partial_cuda(nbr, valid, s_dst, s_src, z.double())


def test_k5_k6_refuse_grad_on_the_card(dev):
    """K5 and K6 have no backward: a card tensor that requires grad under
    grad mode raises instead of returning a result cut off from
    autograd, and nothing is launched."""
    q = torch.randn((2, 64, 32), device=dev).requires_grad_()
    z = torch.randn((3, 8), device=dev).requires_grad_()
    nbr = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    valid = torch.ones((4, 2), dtype=torch.bool, device=dev)
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_cuda(q, q.detach(), q.detach())
    with pytest.raises(RuntimeError, match="no backward"):
        gat_edge_partial_cuda(nbr, valid, torch.zeros(4, device=dev),
                              torch.zeros(3, device=dev), z)
    assert _build.LAUNCHES == before
    with torch.no_grad():
        out = flash_attention_cuda(q, q, q)
    assert out.grad_fn is None and not out.requires_grad


def test_prefill_launches_k6_in_every_layer(dev):
    import dataclasses

    from repro_torch.configs import get_smoke_arch
    from repro_torch.models.transformer import arch_specs, forward
    from repro_torch.nn import init_params
    cfg = dataclasses.replace(get_smoke_arch("qwen3-0.6b"),
                              attn_backend="kernel")
    params = init_params(arch_specs(cfg), torch.Generator().manual_seed(0),
                         dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 100), device=dev)
    before = _build.LAUNCHES["flash_attention"]
    got = forward(cfg, params, toks)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_attention"] == before + cfg.num_layers
    want = forward(dataclasses.replace(cfg, attn_backend="dense"), params,
                   toks)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def _banded_case(seed, rows, deg, n_tab, feat, dev):
    """An out-ELL with the training path's locality: row i's real edges
    fall near slab row i·n_tab/rows (as rcm orders them), a random count
    of them a row, the rest padding on the sentinel row with weight 0."""
    rng = np.random.default_rng(seed)
    centre = (np.arange(rows) * (n_tab - 1) / rows)[:, None]
    nbr = np.clip(centre + rng.normal(scale=300, size=(rows, deg)), 0,
                  n_tab - 2).astype(np.int32)
    live = np.arange(deg)[None, :] < rng.integers(0, deg + 1, (rows, 1))
    nbr = np.where(live, nbr, n_tab - 1).astype(np.int32)
    wts = (rng.random((rows, deg)) * live).astype(np.float32)
    table = rng.normal(size=(n_tab, feat)).astype(np.float32)
    table[-1] = 0
    return (torch.from_numpy(nbr).to(dev), torch.from_numpy(wts).to(dev),
            torch.from_numpy(table).to(dev))


@pytest.mark.parametrize("storage,kind", [("fp32", "skip"), ("bf16", "skip"),
                                          ("int8", "resident")])
@pytest.mark.parametrize("rows,deg", [(5256, 64), (5256, 37), (777, 65),
                                      (129, 1)])
def test_predictor_slab_at_training_shape(dev, storage, kind, rows, deg):
    """The SAT epilogue where the training path selects it: K4 over fp32
    and bf16 pdata, K2 over int8 pdata and pscale, at the (5256, 64) over
    (14289, 128) shape with 256-row chunks and at odd degrees, against
    their plain versions; K4 equal to K3 bit for bit and to itself."""
    n_tab = 14289
    nbr, wts, table = _banded_case(rows + deg, rows, deg, n_tab, 128, dev)
    data, scale = _slab(table, storage)
    pdata, pscale = _slab(0.1 * torch.randn_like(table), storage)
    gamma = 0.75
    if kind == "skip":
        wl = build_chunk_worklist(nbr.cpu().numpy(), n_tab, 256)
        ids = torch.from_numpy(wl.ids).to(dev)
        cnt = torch.from_numpy(wl.cnt).to(dev)
        args = (nbr, wts, data, scale, ids, cnt)
        kw = dict(pdata=pdata, pscale=pscale, gamma=gamma, chunk_rows=256)
        before = _build.LAUNCHES["halo_spmm_skip"]
        got = halo_spmm_skip_cuda(*args, **kw)
        assert torch.equal(got, halo_spmm_skip_cuda(*args, **kw))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["halo_spmm_skip"] == before + 2
        want = halo_spmm_skip_plain(*args, **kw)
        assert torch.equal(got, halo_spmm_stream_cuda(
            nbr, wts, data, scale, pdata, pscale, gamma, chunk_rows=256))
    else:
        args = (nbr, wts, data, scale, pdata, pscale, gamma)
        before = _build.LAUNCHES["halo_spmm"]
        got = halo_spmm_cuda(*args)
        assert torch.equal(got, halo_spmm_cuda(*args))
        torch.cuda.synchronize()
        assert _build.LAUNCHES["halo_spmm"] == before + 2
        want = halo_spmm_plain(*args)
    torch.testing.assert_close(got, want, **TOL)
    assert float(want.abs().max()) > 0


def _train_data(dev):
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    g = make_dataset("flickr-sim", scale=0.15, seed=1)
    return g, prepare_graph_data(g, 2, seed=0, device=dev)


def _gcn(g, **kw):
    from repro_torch.models.gnn import GNNConfig
    return GNNConfig(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                     hidden_dim=16, num_classes=int(g.labels.max()) + 1, **kw)


@pytest.mark.parametrize("storage,ladder,kernel", [
    ("fp32", {}, "halo_spmm"), ("int8", {}, "halo_spmm"),
    ("bf16", {}, "halo_spmm"),
    ("fp32", dict(resident_max_bytes=64, skip_occupancy_max=1.0),
     "halo_spmm_skip")])
def test_predictor_epochs_on_the_kernels(dev, monkeypatch, storage, ladder,
                                        kernel):
    """Predictor epochs (``ema``, interval 1, so the coefficient leaves 0
    by the third push and the pulled pcache carries rows) through the
    kernels against the same epochs through the gather-form oracles on
    the card: losses within 1e-4, and every hidden-layer halo launch of
    the epochs carries pdata."""
    import dataclasses

    from repro_torch.core import PredictorConfig, TrainSettings, digest
    from repro_torch.core.halo_exchange import HaloPrecision
    from repro_torch.kernels.spmm import halo_pull
    from repro_torch.optim import adam

    g, data = _train_data(dev)
    if kernel == "halo_spmm_skip":
        ladder = dict(ladder, halo_occupancy=data["_worklist"].occupancy)
    cfg = _gcn(g, **ladder)
    settings = TrainSettings(sync_interval=1,
                             precision=HaloPrecision(storage),
                             predictor=PredictorConfig("ema"))
    calls = []
    real = halo_pull._launch

    def spy(symbol, counter, nbr, wts, data_, scale, pdata, *a, **k):
        calls.append((counter, pdata is not None))
        return real(symbol, counter, nbr, wts, data_, scale, pdata, *a, **k)

    monkeypatch.setattr(halo_pull, "_launch", spy)
    state, hist = digest.digest_train(cfg, adam(5e-3), data, settings, 5,
                                      eval_every=1)
    oracle = dataclasses.replace(cfg, backend="jnp")
    params = digest.init_state(cfg, adam(5e-3), data)["params"]
    _, want = digest.digest_train(oracle, adam(5e-3), data, settings, 5,
                                  eval_every=1, params=params)
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=0, atol=1e-4)
    assert float(state["predictor"]["coef"].abs().max()) > 0
    assert float(state["pcache"]["data"].float().abs().max()) > 0
    pred_calls = [c for c in calls if c == (kernel, True)]
    assert len(pred_calls) == 2 * 2 * 5, calls      # layers x parts x epochs


def test_kill_and_resume_on_the_card(dev, tmp_path):
    """Faults, the watchdog and the predictor through the kernels: a run
    killed after 4 epochs and resumed to 8 equals the unbroken run bit
    for bit, every leaf on the card."""
    from repro_torch.core import (FaultConfig, PredictorConfig,
                                  TrainSettings, digest)
    from repro_torch.optim import adam

    g, data = _train_data(dev)
    cfg = _gcn(g)
    settings = TrainSettings(sync_interval=2, max_staleness=4,
                             predictor=PredictorConfig("ema"))
    kw = dict(faults=FaultConfig(seed=1, drop_push_rate=0.4,
                                 crash_rate=0.1), ckpt_every=4)
    full, _ = digest.digest_train(cfg, adam(5e-3), data, settings, 8,
                                  ckpt_dir=str(tmp_path / "a"), **kw)
    digest.digest_train(cfg, adam(5e-3), data, settings, 4,
                        ckpt_dir=str(tmp_path / "b"), **kw)
    resumed, _ = digest.digest_train(cfg, adam(5e-3), data, settings, 8,
                                     ckpt_dir=str(tmp_path / "b"),
                                     resume=True, **kw)

    def leaves(t):
        if isinstance(t, dict):
            return [x for k in sorted(t) for x in leaves(t[k])]
        return [t]

    assert set(full) == set(resumed)
    for a, b in zip(leaves(full), leaves(resumed)):
        if isinstance(a, torch.Tensor):
            assert a.is_cuda and b.is_cuda and torch.equal(a, b)
        else:
            assert a == b


def _cv_split(wts, nbr, ncols, fanout, seed):
    """The sampled regime's weight split of an in-ELL (the sampler's draw
    rule, ``graph/sampler.py``): ``min(deg, fanout)`` live slots a row
    kept at scale deg / n_sampled (exactly 1.0 where deg <= fanout),
    ``w_fresh = wts · scale`` (0 at the unsampled live slots) and
    ``w_resid = wts − w_fresh`` (negative at the kept slots of a row
    scaled above 1, +0.0 at every slot of a fully sampled row)."""
    rng = np.random.default_rng(seed)
    valid = (nbr < ncols).cpu().numpy()
    deg = valid.sum(axis=1)
    key = np.where(valid, rng.random(valid.shape), 2.0)
    ranks = np.argsort(np.argsort(key, axis=1, kind="stable"), axis=1)
    n_samp = np.minimum(deg, fanout)
    keep = (ranks < n_samp[:, None]) & valid
    scale = np.where(deg <= fanout, np.float32(1.0),
                     deg.astype(np.float32)
                     / np.maximum(n_samp, 1).astype(np.float32))
    escale = np.where(keep, scale[:, None], np.float32(0)).astype(np.float32)
    w_fresh = wts * torch.from_numpy(escale).to(wts.device)
    return w_fresh, wts - w_fresh, deg


@pytest.mark.parametrize("rows,deg,ncols,feat,live", [
    (300, 14, 301, 16, 5), (5256, 56, 5257, 128, 6), (5256, 56, 5257, 64, 6)])
def test_spmm_kernel_under_the_cv_split(dev, rows, deg, ncols, feat, live):
    """K1 under the sampled regime's weights: zeros at live slots,
    negative residual weights, fully sampled rows whose residual is
    +0.0 — every live slot runs, against the plain version within 1e-5;
    at full coverage ``spmm(w_fresh) + spmm(w_resid)`` equals the
    unsplit K1 bit for bit."""
    nbr, wts, table, _ = _padded_case(rows + feat, rows, deg, ncols, feat,
                                      live, "trailing", dev)
    hist = torch.randn(table.shape, generator=torch.Generator().manual_seed(
        feat)).to(dev)
    hist[-1] = 0
    w_fresh, w_resid, n = _cv_split(wts, nbr, ncols, 3, rows)
    full = torch.from_numpy(n <= 3).to(dev)
    assert bool((w_resid < 0).any()) and bool(full.any())
    assert bool((w_fresh[wts != 0] == 0).any())
    assert bool((w_resid[full].view(torch.int32) == 0).all())   # +0.0
    for w, t in ((w_fresh, table), (w_resid, hist)):
        torch.testing.assert_close(spmm_cuda(nbr, w, t),
                                   spmm_plain(nbr, w, t), **TOL)
    cover_fresh, cover_resid, _ = _cv_split(wts, nbr, ncols, deg, rows)
    assert torch.equal(cover_fresh, wts)
    split = spmm_cuda(nbr, cover_fresh, table) + spmm_cuda(nbr, cover_resid,
                                                           hist)
    torch.cuda.synchronize()
    assert torch.equal(split, spmm_cuda(nbr, wts, table))


@pytest.mark.parametrize("model", ["gcn", "gat"])
def test_sampled_steps_on_the_kernels(dev, model):
    """Sampled CV steps through the kernels against the same steps
    through the gather-form oracles on the card (losses and train F1
    within 1e-4), the table-gradient kernel launched once a hidden layer
    and subgraph a step (gcn: the history's product is not
    differentiated), and full coverage equal to the full-batch epochs
    (gcn bit for bit, gat within 1e-6)."""
    import dataclasses

    from repro_torch.core import TrainSettings, digest
    from repro_torch.graph import build_sampler
    from repro_torch.optim import adam

    g, data = _train_data(dev)
    cfg = dataclasses.replace(_gcn(g), model=model, heads=2)
    settings = TrainSettings(sync_interval=2)
    params = digest.init_state(cfg, adam(5e-3), data)["params"]
    sampler = build_sampler(data, 3, 64, seed=3)
    _build.reset_launches()
    _, hist = digest.sampled_train(cfg, adam(5e-3), data, sampler, settings,
                                   4, eval_every=1, params=params)
    launches = dict(_build.LAUNCHES)
    _, want = digest.sampled_train(dataclasses.replace(cfg, backend="jnp"),
                                   adam(5e-3), data, sampler, settings, 4,
                                   eval_every=1, params=params)
    assert dict(_build.LAUNCHES) == launches      # the oracle launches none
    np.testing.assert_allclose(hist["loss"], want["loss"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(hist["train_f1"], want["train_f1"], rtol=0,
                               atol=1e-4)
    if model == "gcn":
        assert launches["spmm_bwd_table"] == 2 * 2 * 4
        assert launches["spmm_bwd_wts"] == 0
    cover = build_sampler(data, max(sampler.max_in_degree, 1), 1 << 30)
    full, full_h = digest.digest_train(cfg, adam(5e-3), data, settings, 3,
                                       eval_every=1, params=params)
    samp, samp_h = digest.sampled_train(cfg, adam(5e-3), data, cover,
                                        settings, 3, eval_every=1,
                                        params=params)
    for key in ("params", "store"):
        for a, b in zip(_tree_leaves(full[key]), _tree_leaves(samp[key])):
            if model == "gat":
                torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
            else:
                assert torch.equal(a, b)
    if model == "gcn":
        assert full_h["loss"] == samp_h["loss"]


def _tree_leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _tree_leaves(t[k])]
    return [t]
