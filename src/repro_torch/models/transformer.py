"""Decoder-only transformer covering the reference's ten architectures.

One config dataclass (:class:`ArchConfig`, every field of the
reference's, so its config files copy verbatim) and the reference's
block kinds:

  ``"attn"``   GQA self-attention with RoPE and optional qk-norm + SwiGLU
  ``"swa"``    the same attention over a sliding window + SwiGLU
  ``"moe"``    the same attention + the MoE FFN of
               :mod:`repro_torch.models.moe` (+ an optional shared expert)
  ``"rec"``    RG-LRU recurrent block (Griffin) + SwiGLU
  ``"mlstm"``  xLSTM matrix-memory block (internal expansion, no MLP)
  ``"slstm"``  xLSTM scalar-memory block (sequential) + a 2·d SwiGLU
  ``"xattn"``  gated cross-attention to vision patch embeddings + SwiGLU

The recurrent blocks are :mod:`repro_torch.models.recurrent`, plain
PyTorch as the reference's are plain ``jnp``.  The layer stack is
``pattern × repeats + tail``; each ``pattern`` leaf keeps the
reference's stacked layout with a leading ``repeats`` dimension, and the
layers run as a Python loop over it.  ``remat`` is honoured as the
reference honours it (``jax.checkpoint`` around one repeat of the
pattern): under grad each repeat's pattern pass runs inside
``torch.utils.checkpoint`` (non-reentrant), which keeps only its input
and recomputes the rest in the backward; the same ops on the same
inputs, so no bit changes.  ``scan_layers`` is a JAX mechanic with no
effect here, and ``logical_constraint`` (sharding) has no counterpart on
one card.  The embedding gathers differentiate through
``nn.take_rows``, whose backward gives the same bits run to run on the
CPU too.

Prefill (``forward``) runs attention through
:func:`repro_torch.models.attention.prefill_attention` with
``cfg.attn_backend``: ``"kernel"`` takes K6, the hand-written
flash-attention kernel (``swa`` blocks take the chunked path at any
backend, as in the reference).  Decode (``decode_step``) reads a full KV
cache or the stale-KV ``long`` cache (:mod:`repro_torch.models.stale_kv`)
in attention blocks, a ring of the last ``window`` rows in ``swa``
blocks, the recurrent states in ``rec``, ``mlstm`` and ``slstm`` blocks
and the projected vision K/V (:func:`precompute_vision_cache`) in
``xattn`` blocks.  Every cache tensor is updated in place (the new K/V
rows, the ring's slot, the states), so a step copies no cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import (NEG_INF, cross_attention,
                                          decode_attention,
                                          prefill_attention, repeat_kv)
from repro_torch.models.moe import load_balance_loss, moe_ffn
from repro_torch.models.recurrent import (mlstm_parallel, mlstm_step,
                                          rg_lru, rg_lru_step, slstm_scan)
from repro_torch.models.stale_kv import StaleKVConfig, stale_kv_decode
from repro_torch.nn import (ParamSpec, apply_rope, dense, gelu, rms_norm,
                            swiglu, take_rows)

Pytree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    pattern: tuple = ("attn",)
    tail: tuple = ()
    # MoE
    num_experts: int = 0
    experts_per_token: int = 1
    moe_capacity_factor: float = 1.25
    shared_expert: bool = False
    # attention
    qk_norm: bool = False
    rope_theta: float = 500000.0
    window: int = 2048                # for "swa" blocks
    # recurrent
    rnn_dim: int = 0                  # defaults to d_model
    conv_width: int = 4
    mlstm_expansion: int = 2
    # VLM
    vision_dim: int = 0
    num_patches: int = 0
    # long-context (stale-KV)
    long_window: int = 4096
    long_ratio: int = 64
    # numerics / training
    dtype: str = "bfloat16"
    param_dtype: str = "float32"      # matrix weights; norms stay f32
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    remat: bool = True                # checkpoint each repeat under grad
    scan_layers: bool = True          # JAX mechanics: no effect here
    attn_backend: str = "chunked"     # chunked|kernel|dense
    moe_impl: str = "auto"
    source: str = ""

    def __post_init__(self):
        body = self.num_layers - len(self.tail)
        if body % len(self.pattern):
            raise ValueError(
                f"{self.name}: layers {self.num_layers} != "
                f"pattern {self.pattern} x repeats + tail {self.tail}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def repeats(self) -> int:
        return (self.num_layers - len(self.tail)) // len(self.pattern)

    @property
    def rnn(self) -> int:
        return self.rnn_dim or self.d_model

    @property
    def act_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def _map_specs(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return [_map_specs(fn, t) for t in tree]
    return {k: _map_specs(fn, v) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _norm(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="zeros")


def _attn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = {
        "ln1": _norm(d),
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        fan_in_dims=(0, 1)),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = ParamSpec((hd,), ("head_dim",), init="zeros")
    return s


def _mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> dict:
    d = cfg.d_model
    ff = d_ff or cfg.d_ff
    return {
        "ln2": _norm(d),
        "w_gate": ParamSpec((d, ff), ("embed", "mlp")),
        "w_up": ParamSpec((d, ff), ("embed", "mlp")),
        "w_down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def _moe_specs(cfg: ArchConfig) -> dict:
    d, e, ff = cfg.d_model, cfg.num_experts, cfg.d_ff
    s = _attn_specs(cfg)
    s.update({
        "ln2": _norm(d),
        "router": ParamSpec((d, e), ("embed", "expert"), init="normal"),
        "w_gate_e": ParamSpec((e, d, ff), ("expert", "embed", "expert_mlp"),
                              fan_in_dims=(1,)),
        "w_up_e": ParamSpec((e, d, ff), ("expert", "embed", "expert_mlp"),
                            fan_in_dims=(1,)),
        "w_down_e": ParamSpec((e, ff, d), ("expert", "expert_mlp", "embed"),
                              fan_in_dims=(1,)),
    })
    if cfg.shared_expert:
        s.update({
            "ws_gate": ParamSpec((d, ff), ("embed", "mlp")),
            "ws_up": ParamSpec((d, ff), ("embed", "mlp")),
            "ws_down": ParamSpec((ff, d), ("mlp", "embed")),
        })
    return s


def _rec_specs(cfg: ArchConfig) -> dict:
    d, r = cfg.d_model, cfg.rnn
    return {
        "ln1": _norm(d),
        "w_y": ParamSpec((d, r), ("embed", "rnn")),
        "w_x": ParamSpec((d, r), ("embed", "rnn")),
        "conv_w": ParamSpec((cfg.conv_width, r), (None, "rnn"),
                            init="normal"),
        "w_gate_x": ParamSpec((d, r), ("embed", "rnn")),
        "w_gate_a": ParamSpec((d, r), ("embed", "rnn")),
        "log_lambda": ParamSpec((r,), ("rnn",), init="normal"),
        "w_out": ParamSpec((r, d), ("rnn", "embed")),
    }


def _mlstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    di = cfg.mlstm_expansion * d
    h = cfg.num_heads
    dh = di // h
    return {
        "ln1": _norm(d),
        "w_up": ParamSpec((d, 2 * di), ("embed", "mlp")),
        "wq": ParamSpec((di, h, dh), ("mlp", "heads", "head_dim")),
        "wk": ParamSpec((di, h, dh), ("mlp", "heads", "head_dim")),
        "wv": ParamSpec((di, h, dh), ("mlp", "heads", "head_dim")),
        "w_i": ParamSpec((di, h), ("mlp", "heads"), init="normal"),
        "w_f": ParamSpec((di, h), ("mlp", "heads"), init="normal"),
        "w_down": ParamSpec((di, d), ("mlp", "embed")),
    }


def _slstm_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    h = cfg.num_heads
    dh = d // h

    def rec() -> ParamSpec:
        return ParamSpec((h, dh, dh), ("heads", "head_dim", None),
                         fan_in_dims=(1,))

    return {
        "ln1": _norm(d),
        "w_in": ParamSpec((d, h, 4, dh), ("embed", "heads", None,
                                          "head_dim")),
        "r_z": rec(), "r_i": rec(), "r_f": rec(), "r_o": rec(),
        "w_out": ParamSpec((d, d), ("embed", "embed_out")),
        **_mlp_specs(cfg, d_ff=2 * d),
    }


def _xattn_specs(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    vd = cfg.vision_dim
    return {
        "ln1": _norm(d),
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((vd, kv, hd), (None, "kv_heads", "head_dim")),
        "wv": ParamSpec((vd, kv, hd), (None, "kv_heads", "head_dim")),
        "wo": ParamSpec((h, hd, d), ("heads", "head_dim", "embed"),
                        fan_in_dims=(0, 1)),
        "gate": ParamSpec((1,), (None,), init="zeros"),
        **_mlp_specs(cfg),
    }


def _block_specs(cfg: ArchConfig, kind: str) -> dict:
    if kind in ("attn", "swa"):
        return {**_attn_specs(cfg), **_mlp_specs(cfg)}
    if kind == "moe":
        return _moe_specs(cfg)
    if kind == "rec":
        return {**_rec_specs(cfg), **_mlp_specs(cfg)}
    if kind == "mlstm":
        return _mlstm_specs(cfg)
    if kind == "slstm":
        return _slstm_specs(cfg)
    if kind == "xattn":
        return _xattn_specs(cfg)
    raise ValueError(kind)


def _stack_spec(spec: ParamSpec, n: int) -> ParamSpec:
    return ParamSpec((n,) + spec.shape, ("stack",) + spec.axes,
                     init=spec.init, dtype=spec.dtype, scale=spec.scale,
                     fan_in_dims=tuple(d + 1 for d in spec.fan_in_dims))


def arch_specs(cfg: ArchConfig) -> Pytree:
    """The ParamSpec tree: ``embed``, ``final_norm``, ``lm_head``, the
    ``pattern`` list of block dicts stacked over ``repeats`` and the
    ``tail`` list — the reference's tree, leaf for leaf."""
    d = cfg.d_model
    specs: dict[str, Any] = {
        "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                           init="embed", scale=0.02),
        "final_norm": _norm(d),
        "lm_head": ParamSpec((d, cfg.vocab_size), ("embed", "vocab")),
    }
    specs["pattern"] = [
        _map_specs(lambda s: _stack_spec(s, cfg.repeats),
                   _block_specs(cfg, kind))
        for kind in cfg.pattern]
    specs["tail"] = [_block_specs(cfg, kind) for kind in cfg.tail]
    if cfg.param_dtype != "float32":
        # Mixed-precision weight policy: matrix params in bf16, 1-D norm
        # scales kept f32.
        pd = DTYPES[cfg.param_dtype]

        def cast(s: ParamSpec) -> ParamSpec:
            if len(s.shape) <= 1:
                return s
            return dataclasses.replace(s, dtype=pd)

        specs = _map_specs(cast, specs)
    return specs


# ---------------------------------------------------------------------------
# Block forward (prefill)
# ---------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, p: dict, h: torch.Tensor,
         positions: torch.Tensor) -> tuple:
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"].to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"].to(h.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(p: dict, attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return x + torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(attn.dtype))


def _mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"])
    return x + swiglu(h, p["w_gate"].to(h.dtype), p["w_up"].to(h.dtype),
                      p["w_down"].to(h.dtype))


def _moe(cfg: ArchConfig, p: dict, x: torch.Tensor,
         mesh=None) -> torch.Tensor:
    """x + the MoE FFN of rms_norm(x) (+ the shared expert); ``mesh``:
    the ``DeviceMesh`` of the expert-parallel ``moe_ep``."""
    h2 = rms_norm(x, p["ln2"])
    moe_params = {"router": p["router"], "w_gate": p["w_gate_e"],
                  "w_up": p["w_up_e"], "w_down": p["w_down_e"]}
    out = moe_ffn(h2, moe_params, cfg.experts_per_token,
                  impl=cfg.moe_impl, capacity_factor=cfg.moe_capacity_factor,
                  mesh=mesh)
    if cfg.shared_expert:
        out = out + swiglu(h2, p["ws_gate"].to(h2.dtype),
                           p["ws_up"].to(h2.dtype),
                           p["ws_down"].to(h2.dtype))
    return x + out


def _ffn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
         mesh=None) -> torch.Tensor:
    """An attention block's second half: the MoE of "moe", else the
    MLP."""
    return _moe(cfg, p, x, mesh) if kind == "moe" else _mlp(p, x)


def _fwd_attn(cfg, kind, p, x, ctx):
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, ctx["positions"])
    attn = prefill_attention(q, k, v,
                             window=cfg.window if kind == "swa" else 0,
                             backend=cfg.attn_backend)
    return _ffn(cfg, kind, p, _attn_out(p, attn, x), ctx["mesh"])


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in fp32. x: (B, S, D); w: (W, D)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w.shape[0]):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted.float() * w[i].float()
    return out.to(x.dtype)


def _fwd_rec(cfg, kind, p, x, ctx):
    h = rms_norm(x, p["ln1"])
    y = gelu(dense(h, p["w_y"].to(h.dtype)))
    bx = _conv1d_causal(dense(h, p["w_x"].to(h.dtype)), p["conv_w"])
    gx = dense(h, p["w_gate_x"].to(h.dtype))
    ga = dense(h, p["w_gate_a"].to(h.dtype))
    lru, _ = rg_lru(bx, gx, ga, p["log_lambda"])
    x = x + dense(y * lru, p["w_out"].to(h.dtype))
    return _mlp(p, x)


def _fwd_mlstm(cfg, kind, p, x, ctx):
    h = rms_norm(x, p["ln1"])
    up = dense(h, p["w_up"].to(h.dtype))
    di = up.shape[-1] // 2
    xi, gate = up[..., :di], up[..., di:]
    b, s, _ = xi.shape
    q, k, v = (torch.einsum("bsd,dhk->bhsk", xi, p[w].to(xi.dtype))
               for w in ("wq", "wk", "wv"))
    i_pre, f_pre = (torch.einsum("bsd,dh->bhs", xi, p[w].to(xi.dtype))
                    for w in ("w_i", "w_f"))
    core = mlstm_parallel(q, k, v, i_pre, f_pre)           # (B, H, S, dh)
    core = core.transpose(1, 2).reshape(b, s, di)
    return x + dense(core * F.silu(gate), p["w_down"].to(h.dtype))


def _fwd_slstm(cfg, kind, p, x, ctx, state: Optional[dict] = None):
    """The sLSTM block over (B, S, d) from ``state`` (zeros when None).
    Returns (new x, the final state)."""
    h = rms_norm(x, p["ln1"])
    wx = torch.einsum("bsd,dhgk->bshgk", h, p["w_in"].to(h.dtype))
    hs, state = slstm_scan(wx, {g: p[f"r_{g}"] for g in "zifo"}, state)
    b, s = h.shape[:2]
    x = x + dense(hs.reshape(b, s, -1), p["w_out"].to(h.dtype))
    return _mlp(p, x), state


def _xattn(p: dict, x: torch.Tensor, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """x + tanh(gate) * the cross-attention's output (the product in
    fp32, as the reference's fp32 gate promotes it), then the MLP."""
    attn = cross_attention(q, k, v)
    out = torch.einsum("bshk,hkd->bsd", attn, p["wo"].to(attn.dtype))
    gate = torch.tanh(p["gate"].float())[0]
    return _mlp(p, x + (gate * out.float()).to(x.dtype))


def _fwd_xattn(cfg, kind, p, x, ctx):
    vis = ctx["vision"]
    if vis is None:
        raise ValueError(f"{cfg.name}: xattn blocks need a vision input")
    h = rms_norm(x, p["ln1"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bpv,vhk->bphk", vis, p["wk"].to(h.dtype))
    v = torch.einsum("bpv,vhk->bphk", vis, p["wv"].to(h.dtype))
    return _xattn(p, x, q, k, v)


_FWD = {"attn": _fwd_attn, "swa": _fwd_attn, "moe": _fwd_attn,
        "rec": _fwd_rec, "mlstm": _fwd_mlstm,
        "slstm": lambda *a: _fwd_slstm(*a)[0], "xattn": _fwd_xattn}


def _fwd_block(cfg, kind, p, x, ctx):
    if kind not in _FWD:
        raise ValueError(kind)
    return _FWD[kind](cfg, kind, p, x, ctx)


def _layer(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked block dict (views, no copy)."""
    return {k: v[r] for k, v in tree.items()}


def _repeat(cfg: ArchConfig, pattern: list, r: int, x: torch.Tensor,
            ctx: dict) -> torch.Tensor:
    """Repeat ``r`` of the pattern's blocks (the reference's scan body)."""
    for kind, block in zip(cfg.pattern, pattern):
        x = _fwd_block(cfg, kind, _layer(block, r), x, ctx)
    return x


def _embed(cfg: ArchConfig, params: Pytree,
           tokens: torch.Tensor) -> torch.Tensor:
    dt = cfg.act_dtype
    x = take_rows(params["embed"], tokens.long()).to(dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)


def _logits(params: Pytree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return torch.matmul(x.float(), params["lm_head"].float())


def forward(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
            vision: Optional[torch.Tensor] = None,
            mesh=None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, vocab) f32.  ``vision``: the
    (B, num_patches, vision_dim) patch embeddings ``xattn`` blocks
    attend to, cast to the activation dtype.  ``mesh``: the
    ``DeviceMesh`` the MoE blocks' ``moe_ep`` shards its experts over
    (``models.moe``; the tokens are global on every rank, as are the
    logits)."""
    x = _embed(cfg, params, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=x.device),
           "vision": None if vision is None else vision.to(x.dtype),
           "mesh": mesh}
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.repeats):
        if remat:
            x = checkpoint(_repeat, cfg, params["pattern"], r, x, ctx,
                           use_reentrant=False)
        else:
            x = _repeat(cfg, params["pattern"], r, x, ctx)
    for kind, block in zip(cfg.tail, params["tail"]):
        x = _fwd_block(cfg, kind, block, x, ctx)
    return _logits(params, x)


def aux_moe_loss(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                 x_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Router load-balance loss, from the first repeat's router of each
    MoE block of the pattern, on the unscaled fp32 token embeddings (the
    reference's; ``x_embed`` is unused there too)."""
    if cfg.num_experts == 0:
        return torch.zeros((), device=params["embed"].device)
    x = take_rows(params["embed"], tokens.long()).float().reshape(
        -1, cfg.d_model)
    total = torch.zeros((), device=x.device)
    count = 0
    for kind, block in zip(cfg.pattern, params["pattern"]):
        if kind != "moe":
            continue
        logits = x @ block["router"][0].float()
        ids = torch.topk(logits, cfg.experts_per_token, dim=-1).indices
        total = total + load_balance_loss(logits, ids, cfg.num_experts)
        count += 1
    return total / max(count, 1)


def aux_moe_stats(cfg: ArchConfig, params: Pytree,
                  tokens: torch.Tensor) -> list:
    """:func:`aux_moe_loss`'s sums over ``tokens``, one pair a MoE block
    of the pattern: (top-1 dispatch counts (E,), router probability sums
    (E,)), fp32 — what a data-parallel step adds over its ranks before
    the product."""
    x = take_rows(params["embed"], tokens.long()).float().reshape(
        -1, cfg.d_model)
    out = []
    for kind, block in zip(cfg.pattern, params["pattern"]):
        if kind != "moe":
            continue
        logits = x @ block["router"][0].float()
        ids = torch.topk(logits, cfg.experts_per_token, dim=-1).indices
        counts = torch.bincount(ids[:, 0], minlength=cfg.num_experts)
        out.append((counts.float(), torch.softmax(logits, dim=-1).sum(0)))
    return out


# ---------------------------------------------------------------------------
# Decode: caches + single-token step
# ---------------------------------------------------------------------------

def _cache_block_specs(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                       long: bool, dtype) -> dict:
    """ParamSpec tree of one block's decode cache (shape, axes, dtype), the
    reference's: K/V (or stale-KV) rows for "attn" and "moe", a ring of
    ``min(window, max_seq)`` rows for "swa", the projected vision K/V for
    "xattn", fp32 recurrent states (and the conv's last ``W - 1`` inputs
    in the activation dtype) for "rec", "mlstm" and "slstm"."""
    kv, hd = cfg.num_kv_heads, cfg.hd
    kvh = ("batch", "kv_seq", "kv_heads", "head_dim")
    row = ("batch", None, "kv_heads", "head_dim")
    f32 = torch.float32

    def sp(shape, axes, dt=dtype):
        return ParamSpec(shape, axes, init="zeros", dtype=dt)

    def kv_rows(n, axes):
        return sp((batch, n, kv, hd), axes)

    if kind in ("attn", "moe"):
        if long:
            skv = StaleKVConfig(max_seq, cfg.long_window, cfg.long_ratio)
            return {"k_win": kv_rows(skv.window, row),
                    "v_win": kv_rows(skv.window, row),
                    "k_sum": kv_rows(skv.num_slots, kvh),
                    "v_sum": kv_rows(skv.num_slots, kvh),
                    "k_pend": kv_rows(skv.ratio, row),
                    "v_pend": kv_rows(skv.ratio, row)}
        return {"k": kv_rows(max_seq, kvh), "v": kv_rows(max_seq, kvh)}
    if kind == "swa":
        w = min(cfg.window, max_seq)
        return {"k": kv_rows(w, row), "v": kv_rows(w, row)}
    if kind == "xattn":
        axes = ("batch", "patches", "kv_heads", "head_dim")
        return {"k": kv_rows(cfg.num_patches, axes),
                "v": kv_rows(cfg.num_patches, axes)}
    if kind == "rec":
        r = cfg.rnn
        return {"h": sp((batch, r), ("batch", "rnn"), f32),
                "conv": sp((batch, cfg.conv_width - 1, r),
                           ("batch", None, "rnn"))}
    if kind == "mlstm":
        h = cfg.num_heads
        dh = cfg.mlstm_expansion * cfg.d_model // h
        return {"C": sp((batch, h, dh, dh),
                        ("batch", "heads", "head_dim", None), f32),
                "n": sp((batch, h, dh), ("batch", "heads", "head_dim"), f32),
                "m": sp((batch, h), ("batch", "heads"), f32)}
    if kind == "slstm":
        h = cfg.num_heads
        ax = ("batch", "heads", "head_dim")
        return {key: sp((batch, h, cfg.d_model // h), ax, f32)
                for key in ("c", "n", "m", "h")}
    raise ValueError(kind)


def cache_specs(cfg: ArchConfig, batch: int, max_seq: int,
                long: bool = False) -> dict:
    dt = cfg.act_dtype
    return {
        "pattern": [_map_specs(lambda s: _stack_spec(s, cfg.repeats),
                               _cache_block_specs(cfg, kind, batch, max_seq,
                                                  long, dt))
                    for kind in cfg.pattern],
        "tail": [_cache_block_specs(cfg, kind, batch, max_seq, long, dt)
                 for kind in cfg.tail],
        "pos": ParamSpec((batch,), ("batch",), init="zeros",
                         dtype=torch.int32),
    }


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               long: bool = False, device="cuda") -> dict:
    """Zeros of :func:`cache_specs` (mLSTM's ``m`` starts at 0, as the
    reference's does)."""
    dev = resolve_device(device)
    return _map_specs(
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
        cache_specs(cfg, batch, max_seq, long))


def _dec_attn(cfg, p, x, cache, pos, skv: Optional[StaleKVConfig]):
    """x: (B, 1, d) through one attention block's attention against its
    cache — the stale-KV ``long`` cache when ``skv`` is given — which is
    updated in place.  Returns the new x."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, pos[:, None])
    if skv is not None:
        attn, _ = stale_kv_decode(skv, cache, q, k, v, pos)
    else:
        slot = pos[:1].long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        attn = decode_attention(q, cache["k"], cache["v"], pos)
    return _attn_out(p, attn, x)


def _dec_swa(cfg, p, x, cache, pos):
    """A ``swa`` block's attention over its ring (row ``pos % window``
    takes the new K/V in place), masked by each row's absolute position
    as the reference masks it."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, pos[:, None])
    slot = pos[:1].long() % cfg.window
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    ring = cache["k"].shape[1]
    idx = torch.arange(ring, device=x.device)
    p0 = pos[:1].long()
    abs_pos = torch.where(idx <= slot, p0 - slot + idx,
                          p0 - slot + idx - ring)
    rep = cfg.num_heads // cfg.num_kv_heads
    q32 = q[:, 0].float() * cfg.hd ** -0.5
    kf = repeat_kv(cache["k"], rep).float()
    vf = repeat_kv(cache["v"], rep).float()
    logits = torch.einsum("bhd,bshd->bhs", q32, kf)
    mask = (abs_pos >= 0) & (abs_pos <= p0)
    logits = torch.where(mask[None, None, :], logits, NEG_INF)
    pa = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhs,bshd->bhd", pa, vf)[:, None].to(q.dtype)
    return _attn_out(p, attn, x)


def _dec_rec(cfg, p, x, cache):
    h = rms_norm(x, p["ln1"])[:, 0]                        # (B, d)
    y = gelu(h @ p["w_y"].to(h.dtype))
    bx_in = h @ p["w_x"].to(h.dtype)
    conv = cache["conv"]
    w = p["conv_w"].float()
    acc = bx_in.float() * w[0]
    for i in range(1, cfg.conv_width):
        acc = acc + conv[:, -i].float() * w[i]
    bx = acc.to(h.dtype)
    gx = h @ p["w_gate_x"].to(h.dtype)
    ga = h @ p["w_gate_a"].to(h.dtype)
    lru, h_new = rg_lru_step(bx, gx, ga, p["log_lambda"], cache["h"])
    cache["conv"].copy_(torch.cat([conv[:, 1:], bx_in[:, None]], dim=1))
    cache["h"].copy_(h_new)
    x = x + ((y * lru) @ p["w_out"].to(h.dtype))[:, None]
    return _mlp(p, x)


def _dec_mlstm(cfg, p, x, cache):
    h = rms_norm(x, p["ln1"])[:, 0]
    up = h @ p["w_up"].to(h.dtype)
    di = up.shape[-1] // 2
    xi, gate = up[..., :di], up[..., di:]
    q, k, v = (torch.einsum("bd,dhk->bhk", xi, p[w].to(xi.dtype))
               for w in ("wq", "wk", "wv"))
    i_pre, f_pre = (torch.einsum("bd,dh->bh", xi, p[w].to(xi.dtype))
                    for w in ("w_i", "w_f"))
    core, state = mlstm_step(q, k, v, i_pre, f_pre, cache)
    for key, val in state.items():
        cache[key].copy_(val)
    core = core.reshape(core.shape[0], -1)
    out = (core.to(h.dtype) * F.silu(gate)) @ p["w_down"].to(h.dtype)
    return x + out[:, None]


def _dec_slstm(cfg, p, x, cache):
    x, state = _fwd_slstm(cfg, "slstm", p, x, None, state=cache)
    for key, val in state.items():
        cache[key].copy_(val)
    return x


def _dec_xattn(cfg, p, x, cache):
    h = rms_norm(x, p["ln1"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    return _xattn(p, x, q, cache["k"], cache["v"])


def _dec_block(cfg, kind, p, x, cache, pos, skv, mesh=None):
    """One block of a decode step; its cache is updated in place."""
    if kind in ("attn", "moe"):
        return _ffn(cfg, kind, p, _dec_attn(cfg, p, x, cache, pos, skv),
                    mesh)
    if kind == "swa":
        return _mlp(p, _dec_swa(cfg, p, x, cache, pos))
    if kind == "rec":
        return _dec_rec(cfg, p, x, cache)
    if kind == "mlstm":
        return _dec_mlstm(cfg, p, x, cache)
    if kind == "slstm":
        return _dec_slstm(cfg, p, x, cache)
    if kind == "xattn":
        return _dec_xattn(cfg, p, x, cache)
    raise ValueError(kind)


def precompute_vision_cache(cfg: ArchConfig, params: Pytree, cache: dict,
                            vision: torch.Tensor) -> dict:
    """Fill the ``xattn`` blocks' cache (in place) with the vision K/V,
    every repeat projected at once (the reference's ``"bpv,rvhk->rbphk"``).
    ``vision``: (B, num_patches, vision_dim), cast to the activation
    dtype.  Returns the cache."""
    vis = vision.to(cfg.act_dtype)
    for kind, p, entry in zip(cfg.pattern, params["pattern"],
                              cache["pattern"]):
        if kind == "xattn":
            for key, w in (("k", "wk"), ("v", "wv")):
                entry[key].copy_(torch.einsum("bpv,rvhk->rbphk", vis,
                                              p[w].to(vis.dtype)))
    return cache


def decode_step(cfg: ArchConfig, params: Pytree, cache: dict,
                tokens: torch.Tensor, long: bool = False,
                mesh=None) -> tuple:
    """tokens: (B, 1) → (logits (B, 1, vocab), cache).  The cache's
    tensors are updated in place; the returned dict holds them and
    ``pos + 1``.  ``long``: attention blocks read the stale-KV cache,
    sized from the first attention block of the pattern (none: the
    pattern has no such block, and ``long`` changes nothing).  ``mesh``
    as :func:`forward`'s (the cache is global on every rank)."""
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    skv = None
    if long:
        first = next((c for kind, c in zip(cfg.pattern, cache["pattern"])
                      if kind in ("attn", "moe")), None)
        if first is not None:
            n_slots = first["k_sum"].shape[2]
            skv = StaleKVConfig(n_slots * cfg.long_ratio, cfg.long_window,
                                cfg.long_ratio)
    layers = [(kind, _layer(p, r), _layer(c, r)) for r in range(cfg.repeats)
              for kind, p, c in zip(cfg.pattern, params["pattern"],
                                    cache["pattern"])]
    layers += list(zip(cfg.tail, params["tail"], cache["tail"]))
    for kind, p, c in layers:
        x = _dec_block(cfg, kind, p, x, c, pos, skv, mesh)
    return _logits(params, x), {"pattern": cache["pattern"],
                                "tail": cache["tail"], "pos": pos + 1}
