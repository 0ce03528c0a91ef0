"""K6: blocked flash attention forward (online softmax), causal or not.

The LM prefill hotspot: every attention layer of the transformer's
``forward`` with the kernel backend.  :func:`flash_attention_cuda`
launches the hand-written kernel ``csrc/flash_attention.cu`` on CUDA
tensors and runs :func:`flash_attention_plain`, the same blocked
arithmetic in plain PyTorch, on CPU tensors.  There is no fallback: a CUDA
tensor launches the kernel or raises.

Replaces the TPU kernel
``src/repro/kernels/flash_attention/flash_attention.py::flash_attention_pallas``.
It computes what that kernel's ``_attn_kernel`` computes: fp32 running
max, normaliser and accumulator, causal masking with -1e30, K/V tiles
strictly above the diagonal skipped, ``acc / max(l, 1e-30)`` cast back to
the input dtype (``sm_scale`` defaults to ``head_dim ** -0.5``).  fp32
inputs take the reference's arithmetic (Q scaled by ``sm_scale`` first,
every product fp32).  bf16 inputs run on the tensor cores, which take
bf16 operands, so their arithmetic keeps the reference's as closely as
those allow: S is the product of the unscaled bf16 Q and K (exact
products, fp32 sums) scaled by ``sm_scale`` in fp32, and P is split into
``P_hi = bf16(P)`` and ``P_lo = bf16(P - P_hi)`` (:func:`split_bf16`)
before ``acc += P_hi V + P_lo V``, which carries P to about 16 bits.

Two differences of layout, neither of arithmetic:

* **Ragged tiles.**  The reference requires ``seq % block == 0`` (a TPU
  tiling limit).  Here the last Q and K tiles may be ragged: key columns
  past the sequence are masked like causal ones, which adds an exact 0.
* **Grouped-query heads.**  The reference repeats K/V heads before the
  call (``ops.py``).  Here K/V keep their KV heads and query head ``h``
  reads KV head ``h // (H // KV)``.  In the reference's flattened
  ``(batch * heads, seq, head_dim)`` layout that is K/V row ``bh // rep``
  of a ``(batch * kv_heads, seq, head_dim)`` tensor.

The wrappers also take ``(B, H, S, D)`` tensors with any strides over the
first three dims (a ``transpose(1, 2)`` view of the transformer's
``(B, S, H, D)`` activations): the kernel reads and writes through the
strides, so no copy is made.  On the card bf16 tensors are read by TMA,
which needs 16-byte aligned bases and strides (:func:`check_tma`).  On
meta tensors the wrapper runs the card's checks and counts the kernel's
work in the dry ledger (``kernels._build.dry_launch``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# The kernel's (Q rows per block, K/V rows per tile) by input dtype: the
# fp32 body takes 128-row Q tiles, the bf16 body one 64-row tile a
# warpgroup.  The plain version blocks the same way.
BLOCKS = {torch.float32: (128, 64), torch.bfloat16: (64, 64)}
NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 96, 112, 128)   # head dims the kernel is built for
_DTYPES = (torch.float32, torch.bfloat16)


def _as_bhsd(q, k, v):
    """(B, H, S, D) and (B, KV, S, D) views of the inputs.  A 3-D
    ``(bh, seq, hd)`` q whose k/v have ``bh / rep`` rows becomes
    ``(bh / rep, rep, seq, hd)`` over ``(bh / rep, 1, seq, hd)``."""
    if q.dim() == 3:
        if k.dim() != 3 or k.shape[0] == 0 or q.shape[0] % k.shape[0]:
            raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                             "k's rows must divide q's")
        g = k.shape[0]
        return (q.unflatten(0, (g, q.shape[0] // g)), k.unsqueeze(1),
                v.unsqueeze(1))
    if q.dim() != 4:
        raise ValueError(f"q must be (BH, S, D) or (B, H, S, D), got "
                         f"{tuple(q.shape)}")
    return q, k, v


def _check(q, k, v) -> None:
    b, h, s, d = q.shape
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         "be equal (B, KV, S, D)")
    if (k.shape[0] != b or k.shape[2] != s or k.shape[3] != d
            or k.shape[1] == 0 or h % k.shape[1]):
        raise ValueError(f"q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}: need equal B, S, D and "
                         "H % KV == 0")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"q/k/v dtypes {q.dtype} / {k.dtype} / {v.dtype}: "
                        f"all one of {_DTYPES}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device} / "
                         f"{k.device} / {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"unsupported device {q.device}")


def split_bf16(p: torch.Tensor) -> tuple:
    """``(P_hi, P_lo)`` of fp32 ``p``, as fp32 tensors holding bf16 values:
    ``P_hi = bf16(p)``, ``P_lo = bf16(p - P_hi)``.  ``P_hi + P_lo`` is
    within about 2^-17 of ``p`` relative (16 significant bits)."""
    hi = p.to(torch.bfloat16).float()
    return hi, (p - hi).to(torch.bfloat16).float()


def check_tma(t: torch.Tensor) -> None:
    """Raise unless bf16 ``t`` (4-D) can be read by the kernel's TMA
    copies: a 16-byte aligned base, 16-byte aligned strides over its first
    three dims (where the extent exceeds 1) and a unit stride over D."""
    step = 16 // t.element_size()
    if t.stride(3) != 1 or t.data_ptr() % 16 or any(
            t.stride(i) % step for i in range(3) if t.shape[i] > 1):
        raise ValueError(
            f"bf16 tensor of shape {tuple(t.shape)}, strides {t.stride()} "
            f"at byte offset {t.data_ptr() % 16} mod 16: the kernel's TMA "
            "copies need a 16-byte aligned base, strides that are multiples "
            f"of {step} elements and a unit stride over D")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool = True,
                          sm_scale: float | None = None,
                          block_q: int | None = None,
                          block_k: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: for each ``block_q`` Q
    tile, an online softmax over ``block_k`` K/V tiles in order, tiles
    strictly above the diagonal skipped; bf16 inputs take the tensor-core
    arithmetic of the module note (unscaled product, P split in two).
    The blocks default to the kernel's for the dtype (:data:`BLOCKS`).
    Shapes as :func:`flash_attention_cuda`; returns a contiguous
    tensor."""
    shape = q.shape
    q4, k4, v4 = _as_bhsd(q, k, v)
    _check(q4, k4, v4)
    block_q = block_q or BLOCKS[q.dtype][0]
    block_k = block_k or BLOCKS[q.dtype][1]
    b, h, s, d = q4.shape
    rep = h // k4.shape[1]
    scale = d ** -0.5 if sm_scale is None else sm_scale
    bf16 = q.dtype == torch.bfloat16
    qf = q4.float() if bf16 else q4.float() * scale
    kf = k4.float().repeat_interleave(rep, dim=1)
    vf = v4.float().repeat_interleave(rep, dim=1)
    out = torch.empty((b, h, s, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, s, block_q):
        q1 = min(q0 + block_q, s)
        qt = qf[:, :, q0:q1]
        m = torch.full((b, h, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros((b, h, q1 - q0), device=q.device)
        acc = torch.zeros((b, h, q1 - q0, d), device=q.device)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        for k0 in range(0, q1 if causal else s, block_k):
            k1 = min(k0 + block_k, s)
            sc = torch.matmul(qt, kf[:, :, k0:k1].transpose(-1, -2))
            if bf16:
                sc = sc * scale
            if causal:
                k_pos = torch.arange(k0, k1, device=q.device)[None, :]
                sc = torch.where(q_pos >= k_pos, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1)
            vt = vf[:, :, k0:k1]
            if bf16:
                p_hi, p_lo = split_bf16(p)
                pv = torch.matmul(p_hi, vt) + torch.matmul(p_lo, vt)
            else:
                pv = torch.matmul(p, vt)
            acc = acc * alpha[..., None] + pv
            m = m_new
        out[:, :, q0:q1] = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.to(q.dtype).reshape(shape)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True,
                         sm_scale: float | None = None) -> torch.Tensor:
    """Flash attention through the CUDA kernel (plain version on CPU
    tensors).

    Args:
      q: (BH, S, D) as in the reference, or (B, H, S, D) with any strides
         over the first three dims and a unit stride over D.
      k, v: (BH / rep, S, D), or (B, KV, S, D) with H % KV == 0.
      causal: mask keys after the query position.
      sm_scale: the logits' scale; ``D ** -0.5`` when None.
    Inputs are float32 or bfloat16, all one dtype.  On the card D must be
    one of :data:`HEAD_DIMS`.  The kernel has no backward: inputs that
    require grad under grad mode raise, on every device.
    Returns:
      q's shape and dtype; for a 4-D q, the strides of ``empty_like(q)``
      (a ``transpose(1, 2)`` view of a (B, S, H, D) tensor gives such a
      view back).
    """
    q4, k4, v4 = _as_bhsd(q, k, v)
    _check(q4, k4, v4)
    _build.no_backward("flash_attention_cuda (K6)", q, k, v, hint=(
        "as the reference's Pallas kernel, it is a forward only; "
        "differentiate through the chunked or dense attention backend"))
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, sm_scale)
    b, h, s, d = q4.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in the kernel's {HEAD_DIMS}")
    for t in (q4, k4, v4):
        if t.stride(3) != 1:
            raise ValueError("q, k and v need a unit stride over D")
        if t.dtype == torch.bfloat16:
            check_tma(t)
    if max(b * h, s) >= 2 ** 31 or -(-s // BLOCKS[q.dtype][0]) > 65535:
        raise ValueError(f"shape {tuple(q4.shape)} too large for the grid")
    out = torch.empty_like(q4)     # q4's strides where q4 is dense
    if q.is_meta:
        pairs = s * (s + 1) // 2 if causal else s * s
        _build.dry_launch("flash_attention", 4 * b * h * d * pairs,
                          _build.nbytes(q4, k4, v4, out),
                          dtype=str(q.dtype).split(".")[-1])
        return out.reshape(q.shape) if q.dim() == 3 else out
    scale = d ** -0.5 if sm_scale is None else sm_scale
    i64 = ctypes.c_longlong
    fn = _build.kernel_fn("flash_attention", "flash_attention_launch", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, *([i64] * 12), ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p])
    strides = [st for t in (q4, k4, v4, out) for st in t.stride()[:3]]
    code = _build.launch(fn, q, _build.ptr(q4), _build.ptr(k4),
                         _build.ptr(v4), _build.ptr(out),
                         _build.dtype_code(q.dtype), b, h, k4.shape[1], s, d,
                         *strides, int(bool(causal)), float(scale))
    _build.check(code, "flash_attention", "flash_attention_launch")
    _build.LAUNCHES["flash_attention"] += 1
    return out.reshape(q.shape) if q.dim() == 3 else out
