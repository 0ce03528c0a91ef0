"""Recurrent sequence blocks: RG-LRU (RecurrentGemma/Griffin) and xLSTM
(mLSTM + sLSTM), in plain PyTorch.

All three expose a *training* form over (B, S, ...) and a *decode* form
(single step + carried state), as in the reference
(``src/repro/models/recurrent.py``):

  * RG-LRU: a log-depth associative scan over the sequence
    (:func:`associative_scan`, the odd/even recursion ``jax.lax.
    associative_scan`` runs, so the products and sums meet in the
    reference's order).
  * mLSTM: the parallel quadratic form with stabilized exponential gating
    (xLSTM paper, Eq. 19-27).
  * sLSTM: genuinely sequential (hidden-to-hidden recurrence), a Python
    loop over the sequence; xLSTM-1.3b places it in 1 of 8 blocks.

The gates' nonlinearities follow ``jax.nn``: ``softplus`` is
``logaddexp(x, 0)`` (``F.softplus`` switches to ``x`` past a threshold),
``log_sigmoid`` is ``F.logsigmoid``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Associative scan
# ---------------------------------------------------------------------------

def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a0 b0 a1 b1 ... along ``dim``; ``a`` has as many entries as ``b``
    or one more."""
    n = b.shape[dim]
    pairs = torch.stack([a.narrow(dim, 0, n), b], dim=dim + 1)
    out = pairs.flatten(dim, dim + 1)
    if a.shape[dim] > n:
        out = torch.cat([out, a.narrow(dim, n, 1)], dim=dim)
    return out


def _every_other(x: torch.Tensor, dim: int, start: int,
                 stop: Optional[int] = None) -> torch.Tensor:
    idx = [slice(None)] * x.dim()
    idx[dim] = slice(start, stop, 2)
    return x[tuple(idx)]


def associative_scan(fn: Callable, elems: tuple, dim: int) -> tuple:
    """Inclusive scan of the tuple ``elems`` along ``dim`` under the
    associative ``fn(earlier, later)``: the recursion of
    ``jax.lax.associative_scan`` (pairs combined, the half-length scan
    recursed, the even entries filled from the odd ones), ~2 log2 S
    passes of the operands."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(tuple(_every_other(e, dim, 0, n - 1) for e in elems),
                 tuple(_every_other(e, dim, 1) for e in elems))
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(tuple(o.narrow(dim, 0, o.shape[dim] - 1) for o in odd),
                  tuple(_every_other(e, dim, 2) for e in elems))
    else:
        even = fn(odd, tuple(_every_other(e, dim, 2) for e in elems))
    even = tuple(torch.cat([e.narrow(dim, 0, 1), r], dim=dim)
                 for e, r in zip(elems, even))
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

C_RGLRU = 8.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _lru_gates(x, gate_x, gate_a, log_lambda) -> tuple:
    """(a, sqrt(1 - a^2) * i * x) in fp32."""
    r = torch.sigmoid(gate_a.float())
    i = torch.sigmoid(gate_x.float())
    log_a = -C_RGLRU * _softplus(log_lambda.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-9)) \
        * (i * x.float())
    return a, gated


def _lru_combine(c1: tuple, c2: tuple) -> tuple:
    a1, b1 = c1
    a2, b2 = c2
    return a2 * a1, a2 * b1 + b2


def rg_lru(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
           log_lambda: torch.Tensor,
           h0: Optional[torch.Tensor] = None) -> tuple:
    """Real-Gated LRU scan.

    x, gate_x, gate_a: (B, S, D) — input branch and the two gate
    pre-activations; log_lambda: (D,) learned decay parameter; ``h0``
    (B, D) a carried state, folded into the first step.
    Returns (y (B, S, D) in x's dtype, h_last (B, D) fp32).
    """
    a, gated = _lru_gates(x, gate_x, gate_a, log_lambda)
    if h0 is not None:
        first = a[:, :1] * h0[:, None] + gated[:, :1]
        gated = torch.cat([first, gated[:, 1:]], dim=1)
        a = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:]], dim=1)
    _, h = associative_scan(_lru_combine, (a, gated), dim=1)
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(x: torch.Tensor, gate_x: torch.Tensor, gate_a: torch.Tensor,
                log_lambda: torch.Tensor, h: torch.Tensor) -> tuple:
    """One decode step; x, gates: (B, D); h: (B, D) carried fp32 state.
    Returns (y in x's dtype, the new fp32 state)."""
    a, gated = _lru_gates(x, gate_x, gate_a, log_lambda)
    h_new = a * h + gated
    return h_new.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# mLSTM (matrix memory, parallel training form)
# ---------------------------------------------------------------------------

def mlstm_parallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_pre: torch.Tensor, f_pre: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, S, D); i_pre, f_pre: (B, H, S) gate pre-activations.

    Stabilized parallel form (xLSTM Eq. 19-27), in fp32: the (B, H, S, S)
    decay matrix is masked with -inf above the diagonal.
    """
    s, d = q.shape[2], q.shape[3]
    logf = F.logsigmoid(f_pre.float())                     # (B, H, S)
    csum = torch.cumsum(logf, dim=-1)
    # D̃_ij = Σ_{t=j+1}^{i} log f_t + ĩ_j  (j ≤ i)
    dtil = csum[..., :, None] - csum[..., None, :] + i_pre.float()[..., None, :]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=q.device))
    dtil = torch.where(causal, dtil, float("-inf"))
    m = dtil.amax(dim=-1)                                   # (B, H, S)
    dmat = torch.exp(dtil - m[..., None])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (d ** -0.5)
    c = scores * dmat
    norm = torch.maximum(c.sum(dim=-1).abs(), torch.exp(-m))
    out = torch.matmul(c, v.float()) \
        / torch.clamp_min(norm, 1e-12)[..., None]
    return out.to(q.dtype)


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_pre: torch.Tensor, f_pre: torch.Tensor,
               state: dict) -> tuple:
    """One decode step. q, k, v: (B, H, D); i_pre, f_pre: (B, H);
    state: {C (B, H, D, D), n (B, H, D), m (B, H)} in fp32.  Returns
    (out in q's dtype, the new state)."""
    d = q.shape[-1]
    qf = q.float()
    logf = F.logsigmoid(f_pre.float())
    m_new = torch.maximum(logf + state["m"], i_pre.float())
    f_s = torch.exp(logf + state["m"] - m_new)
    i_s = torch.exp(i_pre.float() - m_new)
    kf = k.float() * (d ** -0.5)
    C = f_s[..., None, None] * state["C"] + \
        i_s[..., None, None] * (v.float()[..., :, None] * kf[..., None, :])
    n = f_s[..., None] * state["n"] + i_s[..., None] * kf
    num = torch.matmul(C, qf[..., None])[..., 0]
    den = torch.maximum((n * qf).sum(dim=-1).abs(), torch.exp(-m_new))
    out = num / torch.clamp_min(den, 1e-12)[..., None]
    return out.to(q.dtype), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential)
# ---------------------------------------------------------------------------

def slstm_scan(wx: torch.Tensor, r_weights: dict,
               state: Optional[dict] = None) -> tuple:
    """Sequential sLSTM over a sequence.

    wx: packed input pre-activations (B, S, H, 4, D) for the gates
    (z, i, f, o); r_weights: per-gate recurrent matrices {gate: (H, D, D)}.
    Returns (h (B, S, H, D) in wx's dtype, final fp32 state {c, n, m, h}).
    The four gates' recurrent products run as one batched product a step
    (each output is the same sum over D as the reference's per-gate
    einsum).
    """
    b, s, h, _, d = wx.shape
    if state is None:
        zero = torch.zeros((b, h, d), device=wx.device)
        state = {"c": zero, "n": zero, "h": zero, "m": zero}
    # (H, D, 4 * D): gate g's matrix in columns g * D .. (g + 1) * D.
    r_all = torch.cat([r_weights[g].float() for g in "zifo"], dim=-1)
    xs = wx.float()
    c, n, m, h_prev = state["c"], state["n"], state["m"], state["h"]
    hs = []
    for t in range(s):
        rec = torch.matmul(h_prev.transpose(0, 1), r_all).transpose(0, 1)
        pre = xs[:, t] + rec.reshape(b, h, 4, d)
        z = torch.tanh(pre[:, :, 0])
        i_pre, f_pre = pre[:, :, 1], pre[:, :, 2]
        o = torch.sigmoid(pre[:, :, 3])
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        i_s = torch.exp(i_pre - m_new)
        f_s = torch.exp(logf + m - m_new)
        c = f_s * c + i_s * z
        n = f_s * n + i_s
        h_prev = o * c / torch.clamp_min(n, 1e-12)
        m = m_new
        hs.append(h_prev)
    out = torch.stack(hs, dim=1).to(wx.dtype)
    return out, {"c": c, "n": n, "m": m, "h": h_prev}
