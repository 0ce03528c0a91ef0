"""The summation order K3's and K4's bodies rely on, checked on the CPU.

K3 (``csrc/halo_pull.cu``) sorts a row's edges by (chunk, k) and streams
them, closing a chunk's partial where the chunk changes; it never visits
a chunk the row does not read and never adds an edge outside its own
chunk.  Its plain version instead adds, for every chunk, a partial over
all k with out-of-chunk edges weighted 0.  These tests hold the two
orders equal bit for bit on unsorted rows, whose chunks interleave in k
(``torch.equal``, which accepts either sign of zero), and hold the plain
versions to each other and to the reference:

* K3's plain version == K4's with a full worklist, and with the row
  blocks' own worklists (the sentinel row's chunk left off);
* K3's plain version over one chunk == K2's;
* K3's plain version within 1e-5 (atol = rtol) of the reference's
  ``halo_spmm_stream_pallas`` in interpret mode at chunk_rows 1 and 7
  (the port takes each product rounded before its add, as the Pallas
  body's jnp does; the tolerance covers XLA's freedom to fuse).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import halo_exchange as jhx
from repro.kernels.spmm import halo_spmm_stream_pallas
from repro_torch.graph import build_chunk_worklist
from repro_torch.kernels.spmm import (SKIP_BLOCK_ROWS, halo_spmm_plain,
                                      halo_spmm_skip_plain,
                                      halo_spmm_stream_cuda,
                                      halo_spmm_stream_plain,
                                      halo_spmm_stream_walk_cuda)

TOL = dict(atol=1e-5, rtol=1e-5)
GAMMA = 0.7


def _case(seed, storage, pred, rows=140, deg=20, n_tab=90, feat=16):
    """Unsorted rows over the whole slab (each row's chunks interleave in
    k); padding slots (one in five) point at the zero sentinel row
    n_tab - 1 with weight 0.  Returns numpy arrays quantised by the
    reference."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_tab - 1, size=(rows, deg)).astype(np.int32)
    pad = rng.random((rows, deg)) < 0.2
    nbr[pad] = n_tab - 1
    wts = (rng.random((rows, deg)) * ~pad).astype(np.float32)
    slabs = []
    for _ in range(2 if pred else 1):
        table = rng.normal(size=(n_tab, feat)).astype(np.float32)
        table[-1] = 0
        data, scale = jhx.quantize_rows(jnp.asarray(table),
                                        jhx.HaloPrecision(storage))
        slabs += [data, scale]
    if not pred:
        slabs += [None, None]
    return (nbr, wts, *slabs)


def _t(x):
    """numpy / jax array → CPU tensor (bf16 through an exact fp32 hop)."""
    if x is None:
        return None
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _args(seed, storage, pred, **shape):
    return tuple(_t(a) for a in _case(seed, storage, pred, **shape))


def _list_order(nbr, wts, data, scale, pdata, pscale, chunk_rows):
    """K3's kernel order in plain PyTorch, row by row: the row's edges
    stably sorted by chunk, each chunk's partial from +0.0 over its edges
    in ascending k, added to the total where the chunk changes.  Each
    term is the plain version's (product rounded, then added)."""
    out = torch.zeros((nbr.shape[0], data.shape[1]), dtype=torch.float32)
    gamma = torch.tensor(GAMMA, dtype=torch.float32)
    for i in range(nbr.shape[0]):
        s = nbr[i].long()
        order = torch.sort(torch.div(s, chunk_rows, rounding_mode="floor"),
                           stable=True).indices
        total = torch.zeros(data.shape[1])
        part = torch.zeros(data.shape[1])
        cur = None
        for k in order.tolist():
            c = int(s[k]) // chunk_rows
            if cur is not None and c != cur:
                total, part = total + part, torch.zeros(data.shape[1])
            cur = c
            w = wts[i, k]
            ws = w if scale is None else w * scale[s[k], 0]
            part = part + ws * data[s[k]].float()
            if pdata is not None:
                wp = w * gamma
                if pscale is not None:
                    wp = wp * pscale[s[k], 0]
                part = part + wp * pdata[s[k]].float()
        out[i] = total + part
    return out


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("chunk_rows", [1, 7, 16, 89])
def test_list_order_equals_stream_plain(storage, pred, chunk_rows):
    """Skipping the chunks a row does not read, and every edge outside its
    own chunk, changes nothing: K3's kernel order == its plain version."""
    nbr, wts, data, scale, pdata, pscale = _args(3 + chunk_rows, storage,
                                                 pred, rows=24)
    want = halo_spmm_stream_plain(nbr, wts, data, scale, pdata, pscale,
                                  GAMMA, chunk_rows)
    got = _list_order(nbr, wts, data, scale, pdata, pscale, chunk_rows)
    assert torch.equal(got, want)


def _full_worklist(rows, n_chunks):
    n_blocks = max(-(-rows // SKIP_BLOCK_ROWS), 1)
    ids = np.tile(np.arange(n_chunks, dtype=np.int32), (n_blocks, 1))
    cnt = np.full(n_blocks, n_chunks, np.int32)
    return torch.from_numpy(ids), torch.from_numpy(cnt)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("chunk_rows", [1, 7, 64])
def test_stream_plain_equals_skip_plain(storage, pred, chunk_rows):
    """K3's plain version == K4's over a worklist listing every chunk, and
    over the row blocks' own worklists, bit for bit."""
    nbr, wts, data, scale, pdata, pscale = _args(5 + chunk_rows, storage,
                                                 pred)
    kw = dict(pdata=pdata, pscale=pscale, gamma=GAMMA,
              chunk_rows=chunk_rows)
    k3 = halo_spmm_stream_plain(nbr, wts, data, scale, pdata, pscale, GAMMA,
                                chunk_rows)
    n_chunks = -(-data.shape[0] // chunk_rows)
    ids, cnt = _full_worklist(nbr.shape[0], n_chunks)
    assert torch.equal(halo_spmm_skip_plain(nbr, wts, data, scale, ids, cnt,
                                            **kw), k3)
    wl = build_chunk_worklist(nbr.numpy(), data.shape[0], chunk_rows)
    own = halo_spmm_skip_plain(nbr, wts, data, scale,
                               torch.from_numpy(wl.ids),
                               torch.from_numpy(wl.cnt), **kw)
    assert torch.equal(own, k3)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
def test_stream_plain_one_chunk_equals_resident_plain(storage, pred):
    """One chunk covering the slab: K3's plain version == K2's, through
    the K3 wrapper and its walk-body wrapper too (on CPU tensors both run
    the plain version)."""
    nbr, wts, data, scale, pdata, pscale = _args(9, storage, pred)
    args = (nbr, wts, data, scale, pdata, pscale, GAMMA)
    k2 = halo_spmm_plain(*args)
    n_tab = data.shape[0]
    assert torch.equal(halo_spmm_stream_plain(*args, chunk_rows=n_tab), k2)
    assert torch.equal(halo_spmm_stream_cuda(*args, chunk_rows=n_tab), k2)
    assert torch.equal(halo_spmm_stream_walk_cuda(*args, chunk_rows=n_tab),
                       k2)
    with pytest.raises(ValueError, match="chunk_rows"):
        halo_spmm_stream_walk_cuda(*args, chunk_rows=0)


@pytest.mark.parametrize("storage", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("pred", [False, True])
@pytest.mark.parametrize("chunk_rows", [1, 7])
def test_stream_plain_matches_reference_kernel(storage, pred, chunk_rows):
    """K3's plain version against the reference's streamed Pallas kernel
    (interpret mode) with one- and seven-row chunks over a 40-row slab,
    whose last chunk is ragged at 7."""
    nbr, wts, data, scale, pdata, pscale = _case(
        13 + chunk_rows, storage, pred, rows=24, deg=12, n_tab=40)
    want = halo_spmm_stream_pallas(jnp.asarray(nbr), jnp.asarray(wts), data,
                                   scale, pdata=pdata, pscale=pscale,
                                   gamma=GAMMA, chunk_rows=chunk_rows,
                                   interpret=True)
    got = halo_spmm_stream_plain(*(_t(a) for a in (nbr, wts, data, scale,
                                                   pdata, pscale)),
                                 GAMMA, chunk_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               **TOL)
