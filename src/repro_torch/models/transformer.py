"""Decoder-only transformer: the dense and MoE members of the reference's
family.

One config dataclass (:class:`ArchConfig`, every field of the
reference's, so its config files copy verbatim) and the block kinds
``"attn"`` (GQA self-attention with RoPE and optional qk-norm, then a
SwiGLU MLP) and ``"moe"`` (the same attention, then the MoE FFN of
:mod:`repro_torch.models.moe`, plus an optional shared expert).  The
layer stack is ``pattern × repeats + tail``; each ``pattern`` leaf keeps
the reference's stacked layout with a leading ``repeats`` dimension, and
the layers run as a Python loop over it.  ``remat`` is honoured as the
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
flash-attention kernel.  Decode (``decode_step``) reads a full KV cache
or the stale-KV ``long`` cache (:mod:`repro_torch.models.stale_kv`); the
new K/V rows are written into the cache's tensors in place, so a step
copies no cache.

The block kinds ``swa`` and ``rec`` (ROADMAP.md §1 item 8b), ``mlstm``
and ``slstm`` (item 8c), ``xattn`` and the vision inputs (item 8d) raise
``NotImplementedError`` naming their item.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, prefill_attention
from repro_torch.models.moe import load_balance_loss, moe_ffn
from repro_torch.models.stale_kv import StaleKVConfig, stale_kv_decode
from repro_torch.nn import (ParamSpec, apply_rope, rms_norm, swiglu,
                            take_rows)

Pytree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PORTED_KINDS = ("attn", "moe")
# The ROADMAP.md §1 item that ports each block kind not ported yet.
UNPORTED_KINDS = {"swa": "8b", "rec": "8b", "mlstm": "8c", "slstm": "8c",
                  "xattn": "8d"}


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md §1 item {item}")


def _unported_kind(cfg, kind: str, what: str = "block kind"):
    if kind not in UNPORTED_KINDS:
        raise ValueError(kind)
    _unported(f"{cfg.name}: {what} {kind!r}", UNPORTED_KINDS[kind])


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


def _check_kinds(cfg: ArchConfig) -> None:
    for kind in (*cfg.pattern, *cfg.tail):
        if kind not in PORTED_KINDS:
            _unported_kind(cfg, kind)


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


def _mlp_specs(cfg: ArchConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
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


def _block_specs(cfg: ArchConfig, kind: str) -> dict:
    if kind == "attn":
        return {**_attn_specs(cfg), **_mlp_specs(cfg)}
    if kind == "moe":
        return _moe_specs(cfg)
    _unported_kind(cfg, kind)


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


def _moe(cfg: ArchConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + the MoE FFN of rms_norm(x) (+ the shared expert)."""
    h2 = rms_norm(x, p["ln2"])
    moe_params = {"router": p["router"], "w_gate": p["w_gate_e"],
                  "w_up": p["w_up_e"], "w_down": p["w_down_e"]}
    out = moe_ffn(h2, moe_params, cfg.experts_per_token,
                  impl=cfg.moe_impl, capacity_factor=cfg.moe_capacity_factor)
    if cfg.shared_expert:
        out = out + swiglu(h2, p["ws_gate"].to(h2.dtype),
                           p["ws_up"].to(h2.dtype),
                           p["ws_down"].to(h2.dtype))
    return x + out


def _ffn(cfg: ArchConfig, kind: str, p: dict,
         x: torch.Tensor) -> torch.Tensor:
    """The block's second half: the MLP of "attn", the MoE of "moe"."""
    return _mlp(p, x) if kind == "attn" else _moe(cfg, p, x)


def _fwd_block(cfg, kind, p, x, ctx):
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, ctx["positions"])
    attn = prefill_attention(q, k, v, backend=cfg.attn_backend)
    return _ffn(cfg, kind, p, _attn_out(p, attn, x))


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
            vision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, vocab) f32."""
    _check_kinds(cfg)
    if vision is not None:
        _unported("vision input (VLM)", "8d")
    x = _embed(cfg, params, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=x.device)}
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


# ---------------------------------------------------------------------------
# Decode: caches + single-token step
# ---------------------------------------------------------------------------

def _cache_block_specs(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                       long: bool, dtype) -> dict:
    """ParamSpec tree of one block's decode cache (shape, axes, dtype):
    "attn" and "moe" blocks keep the same K/V (or stale-KV) cache."""
    if kind not in PORTED_KINDS:
        _unported_kind(cfg, kind, "decode cache of block kind")
    kv, hd = cfg.num_kv_heads, cfg.hd
    kvh = ("batch", "kv_seq", "kv_heads", "head_dim")
    row = ("batch", None, "kv_heads", "head_dim")

    def sp(n, axes):
        return ParamSpec((batch, n, kv, hd), axes, init="zeros", dtype=dtype)

    if long:
        skv = StaleKVConfig(max_seq, cfg.long_window, cfg.long_ratio)
        return {"k_win": sp(skv.window, row), "v_win": sp(skv.window, row),
                "k_sum": sp(skv.num_slots, kvh),
                "v_sum": sp(skv.num_slots, kvh),
                "k_pend": sp(skv.ratio, row), "v_pend": sp(skv.ratio, row)}
    return {"k": sp(max_seq, kvh), "v": sp(max_seq, kvh)}


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


def precompute_vision_cache(cfg: ArchConfig, params: Pytree, cache: dict,
                            vision: torch.Tensor) -> dict:
    _unported("precompute_vision_cache (VLM)", "8d")


def decode_step(cfg: ArchConfig, params: Pytree, cache: dict,
                tokens: torch.Tensor, long: bool = False) -> tuple:
    """tokens: (B, 1) → (logits (B, 1, vocab), cache).  The cache's K/V
    tensors are updated in place; the returned dict holds them and
    ``pos + 1``."""
    _check_kinds(cfg)
    x = _embed(cfg, params, tokens)
    pos = cache["pos"]
    skv = None
    if long:
        # Infer S from the summary table of the first attention block.
        n_slots = cache["pattern"][0]["k_sum"].shape[2]
        skv = StaleKVConfig(n_slots * cfg.long_ratio, cfg.long_window,
                            cfg.long_ratio)
    layers = [(kind, _layer(p, r), _layer(c, r)) for r in range(cfg.repeats)
              for kind, p, c in zip(cfg.pattern, params["pattern"],
                                    cache["pattern"])]
    layers += list(zip(cfg.tail, params["tail"], cache["tail"]))
    for kind, p, c in layers:
        x = _ffn(cfg, kind, p, _dec_attn(cfg, p, x, c, pos, skv))
    return _logits(params, x), {"pattern": cache["pattern"],
                                "tail": cache["tail"], "pos": pos + 1}
