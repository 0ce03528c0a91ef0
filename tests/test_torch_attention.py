"""K6's plain version (what ``flash_attention_cuda`` runs on CPU tensors)
and the port's attention functions against the reference: the Pallas
kernel in interpret mode and the jnp oracles, on the reference's own
parametrisation (tests/test_kernels_attention.py).

Tolerances: 2e-5 (atol = rtol) in fp32, the reference's kernel bar —
the same online softmax, with products of another library.  In bf16
the inputs are the same bf16 values and both sides compute in fp32 and
round once: the outputs may then differ by the fp32 bar plus one bf16
ulp of the output (2^-7 of its binade).  The port's bf16 arithmetic
(the tensor cores': unscaled product, P split into two bf16 halves)
keeps P to about 16 bits, so it stays inside that bar.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention import attention_ref as jattention_ref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.flash_attention import \
    multi_head_attention as jmulti_head_attention
from repro.models import attention as jattn
from repro_torch.kernels.flash_attention import (BLOCKS, attention_ref,
                                                 check_tma,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 multi_head_attention,
                                                 split_bf16)
from repro_torch.models import attention as tattn

TOL = dict(atol=2e-5, rtol=2e-5)


def _qkv(rng, shape_q, shape_kv, dtype=np.float32):
    q = rng.normal(size=shape_q).astype(dtype)
    k = rng.normal(size=shape_kv).astype(dtype)
    v = rng.normal(size=shape_kv).astype(dtype)
    return q, k, v


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value's magnitude: 2^(exponent - 7)."""
    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


@pytest.mark.parametrize("seq,hd,bq,bk", [
    (128, 64, 128, 128), (256, 64, 128, 64), (256, 128, 64, 128),
    (512, 32, 128, 128), (256, 128, 128, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_pallas(seq, hd, bq, bk, causal):
    rng = np.random.default_rng(seq + hd)
    q, k, v = _qkv(rng, (2, seq, hd), (2, seq, hd))
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, block_q=bq, block_k=bk,
                                  interpret=True)
    tq, tk, tv = _t(q, k, v)
    # The reference's own blocking, and the kernel's (64 x 64) through the
    # wrapper, which takes the plain version on CPU tensors.
    _close(flash_attention_plain(tq, tk, tv, causal, block_q=bq,
                                 block_k=bk), want)
    _close(flash_attention_cuda(tq, tk, tv, causal), want)
    ref = attention_ref(tq, tk, tv, causal)
    _close(ref, jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal))
    _close(ref, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_plain_blocks_follow_the_dtype(dtype):
    """The plain version's default blocks are the kernel's for the dtype
    (BLOCKS: 128-row Q tiles in fp32, 64 in bf16), on a ragged causal
    sequence where the Q block decides which masked K tiles a row
    visits."""
    rng = np.random.default_rng(11)
    q, k, v = (t.to(dtype) for t in _t(*_qkv(rng, (2, 200, 32),
                                              (2, 200, 32))))
    bq, bk = BLOCKS[dtype]
    assert (bq, bk) == ((128, 64) if dtype == torch.float32 else (64, 64))
    assert torch.equal(flash_attention_plain(q, k, v, True),
                       flash_attention_plain(q, k, v, True, block_q=bq,
                                             block_k=bk))


@pytest.mark.parametrize("seq", [1, 63, 100, 129])
def test_flash_plain_ragged_tiles(seq):
    """Sequences that are no multiple of 64: the last tiles are ragged
    (the reference's Pallas kernel refuses them; its oracle does not)."""
    rng = np.random.default_rng(seq)
    q, k, v = _qkv(rng, (3, seq, 32), (3, seq, 32))
    for causal in (True, False):
        want = jattention_ref(*map(jnp.asarray, (q, k, v)), causal=causal)
        _close(flash_attention_cuda(*_t(q, k, v), causal), want)


def test_flash_plain_grouped_heads_and_strided_views():
    """GQA without repeating K/V: the 3-D layout with k of bh / rep rows,
    and the 4-D (B, H, S, D) transpose view of (B, S, H, D)."""
    rng = np.random.default_rng(7)
    b, s, h, kv, d = 2, 96, 8, 2, 32
    q, k, v = _qkv(rng, (b, s, h, d), (b, s, kv, d))
    rep = h // kv
    kr, vr = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)

    def flat(x):
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
            -1, s, d)

    want = jattention_ref(*map(jnp.asarray, (flat(q), flat(kr), flat(vr))))
    got3 = flash_attention_cuda(*_t(flat(q), flat(k), flat(v)))
    assert got3.shape == (b * h, s, d)
    _close(got3, want)
    tq, tk, tv = _t(q, k, v)
    got4 = flash_attention_cuda(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2))
    assert got4.shape == (b, h, s, d)
    _close(got4.reshape(b * h, s, d), want)


def test_flash_plain_bf16_within_one_ulp():
    rng = np.random.default_rng(11)
    q, k, v = _qkv(rng, (2, 256, 64), (2, 256, 64))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (tq, tk, tv)]
    want = torch.from_numpy(np.array(flash_attention_pallas(
        *j, causal=True, block_q=64, block_k=64,
        interpret=True).astype(jnp.float32)))
    got = flash_attention_cuda(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs()
    assert bool((err <= 2e-5 + bf16_ulp(want)).all()), float(err.max())


@pytest.mark.parametrize("seq,hd", [(1, 16), (64, 16), (100, 32),
                                    (130, 96), (256, 64), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16_tensor_core_arithmetic(seq, hd, causal):
    """The bf16 plain version (the kernel's tensor-core arithmetic)
    against the Pallas kernel on the same bf16 inputs, ragged S included
    (one Pallas tile where 64 does not divide S)."""
    rng = np.random.default_rng(seq * hd + causal)
    q, k, v = _qkv(rng, (3, seq, hd), (3, seq, hd))
    tq, tk, tv = (t.to(torch.bfloat16) for t in _t(q, k, v))
    j = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
         for t in (tq, tk, tv)]
    block = 64 if seq % 64 == 0 else seq
    want = torch.from_numpy(np.array(flash_attention_pallas(
        *j, causal=causal, block_q=block, block_k=block,
        interpret=True).astype(jnp.float32)))
    got = flash_attention_plain(tq, tk, tv, causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    err = (got.float() - want).abs()
    assert bool((err <= 2e-5 + bf16_ulp(want)).all()), float(err.max())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_bf16_carries_16_bits(seed):
    """P_hi + P_lo reproduces P within 2^-16 relative, each half a bf16
    value, over softmax weights spanning many binades."""
    rng = np.random.default_rng(seed)
    p = torch.from_numpy(np.exp(-rng.random(4096) * 60).astype(np.float32))
    hi, lo = split_bf16(p)
    for half in (hi, lo):
        assert torch.equal(half.to(torch.bfloat16).float(), half)
    assert bool(((hi + lo - p).abs() <= 2.0 ** -16 * p).all())
    # One bf16 alone misses that by far: 8 bits.
    assert float(((hi - p).abs() / p).max()) > 2.0 ** -10


def test_check_tma_refuses_unaligned_strides():
    """bf16 views the kernel's TMA copies cannot read are refused."""
    x = torch.zeros((2, 64, 4, 36), dtype=torch.bfloat16)
    check_tma(x[..., :32].transpose(1, 2).contiguous())
    check_tma(torch.zeros((2, 64, 4, 32), dtype=torch.bfloat16
                          ).transpose(1, 2))
    with pytest.raises(ValueError, match="TMA"):
        check_tma(x[..., :32].transpose(1, 2))       # head stride 36
    with pytest.raises(ValueError, match="TMA"):
        check_tma(x.view(-1)[1:1 + 2 * 4 * 64 * 32].view(2, 4, 64, 32))


def test_flash_wrapper_refuses_bad_inputs():
    q = torch.zeros((2, 8, 16))
    with pytest.raises(TypeError):
        flash_attention_cuda(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        flash_attention_cuda(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, torch.zeros((3, 8, 16)), q)
    with pytest.raises(ValueError):
        flash_attention_cuda(q[None], torch.zeros((1, 2, 9, 16)),
                             torch.zeros((1, 2, 9, 16)))


def test_multi_head_attention_gqa():
    rng = np.random.default_rng(3)
    b, s, h, d, kv = 2, 128, 8, 32, 2
    q, k, v = _qkv(rng, (b, s, h, d), (b, s, kv, d))
    want = jmulti_head_attention(*map(jnp.asarray, (q, k, v)),
                                 backend="jnp")
    for backend in ("auto", "jnp"):
        got = multi_head_attention(*_t(q, k, v), backend=backend)
        assert got.shape == (b, s, h, d)
        _close(got, want)


@pytest.mark.parametrize("window,chunk,q_offset", [(0, 64, 0), (0, 80, 0),
                                                   (32, 32, 0),
                                                   (0, 64, 20)])
def test_chunked_attention_matches_reference(window, chunk, q_offset):
    rng = np.random.default_rng(5 + window + chunk)
    b, sq, sk, h, d, kv = 2, 192, 192 + q_offset, 4, 32, 2
    q, k, v = _qkv(rng, (b, sq, h, d), (b, sk, kv, d))
    kw = dict(causal=True, window=window, chunk=chunk, q_offset=q_offset)
    want = jattn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(tattn.chunked_attention(*_t(q, k, v), **kw), want)


def test_prefill_attention_backends_agree():
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, (2, 70, 4, 16), (2, 70, 2, 16))
    want = jattn.prefill_attention(*map(jnp.asarray, (q, k, v)),
                                   backend="dense")
    for backend in ("kernel", "dense", "chunked"):
        _close(tattn.prefill_attention(*_t(q, k, v), backend=backend), want)
    want = jattn.prefill_attention(*map(jnp.asarray, (q, k, v)), window=16,
                                   backend="pallas")
    _close(tattn.prefill_attention(*_t(q, k, v), window=16,
                                   backend="kernel"), want)
    with pytest.raises(ValueError, match="backend"):
        tattn.prefill_attention(*_t(q, k, v), backend="pallas")


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_matches_reference(window):
    rng = np.random.default_rng(13 + window)
    b, s, h, d, kv = 3, 24, 4, 16, 2
    q, k, v = _qkv(rng, (b, 1, h, d), (b, s, kv, d))
    pos = np.array([0, 9, 23], np.int32)
    want = jattn.decode_attention(*map(jnp.asarray, (q, k, v, pos)),
                                  window=window)
    got = tattn.decode_attention(*_t(q, k, v, pos), window=window)
    assert got.shape == (b, 1, h, d)
    _close(got, want)
