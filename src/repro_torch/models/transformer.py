"""Decoder-only transformer: the dense subset of the reference's family.

One config dataclass (:class:`ArchConfig`, every field of the
reference's, so its config files copy verbatim) and the block kind
``"attn"``: GQA self-attention (RoPE, optional qk-norm) + SwiGLU MLP.  The
layer stack is ``pattern × repeats + tail``; each ``pattern`` leaf keeps
the reference's stacked layout with a leading ``repeats`` dimension, and
the layers run as a Python loop over it.  The reference's ``remat`` and
``scan_layers`` are JAX mechanics and have no effect here; its
``logical_constraint`` (sharding) has no counterpart on one card.

Prefill (``forward``) runs attention through
:func:`repro_torch.models.attention.prefill_attention` with
``cfg.attn_backend``: ``"kernel"`` takes K6, the hand-written
flash-attention kernel.  Decode (``decode_step``) reads a full KV cache
or the stale-KV ``long`` cache (:mod:`repro_torch.models.stale_kv`); the
new K/V rows are written into the cache's tensors in place, so a step
copies no cache.

The block kinds ``moe``, ``swa``, ``rec``, ``mlstm``, ``slstm`` and
``xattn`` and the vision inputs raise ``NotImplementedError``: they are
ROADMAP.md §1 item 8.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import decode_attention, prefill_attention
from repro_torch.models.stale_kv import StaleKVConfig, stale_kv_decode
from repro_torch.nn import ParamSpec, apply_rope, rms_norm, swiglu

Pytree = Any

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
PORTED_KINDS = ("attn",)


def _unported(what: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP.md §1 item 8 (MoE, "
        "sliding-window, recurrent, xLSTM and VLM blocks)")


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
    remat: bool = True                # JAX mechanics: no effect here
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
            _unported(f"{cfg.name}: block kind {kind!r}")


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


def _block_specs(cfg: ArchConfig, kind: str) -> dict:
    if kind == "attn":
        return {**_attn_specs(cfg), **_mlp_specs(cfg)}
    _unported(f"{cfg.name}: block kind {kind!r}")


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


def _fwd_attn(cfg, p, x, ctx, *, window=0):
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, ctx["positions"])
    attn = prefill_attention(q, k, v, window=window,
                             backend=cfg.attn_backend)
    x = _attn_out(p, attn, x)
    return _mlp(p, x)


def _layer(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked block dict (views, no copy)."""
    return {k: v[r] for k, v in tree.items()}


def _embed(cfg: ArchConfig, params: Pytree,
           tokens: torch.Tensor) -> torch.Tensor:
    dt = cfg.act_dtype
    x = params["embed"][tokens.long()].to(dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)


def _logits(params: Pytree, x: torch.Tensor) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    return torch.matmul(x.float(), params["lm_head"].float())


def forward(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
            vision: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, vocab) f32."""
    _check_kinds(cfg)
    if vision is not None:
        _unported("vision input (VLM)")
    x = _embed(cfg, params, tokens)
    ctx = {"positions": torch.arange(tokens.shape[1], device=x.device)}
    for r in range(cfg.repeats):
        for block in params["pattern"]:
            x = _fwd_attn(cfg, _layer(block, r), x, ctx)
    for block in params["tail"]:
        x = _fwd_attn(cfg, block, x, ctx)
    return _logits(params, x)


# ---------------------------------------------------------------------------
# Decode: caches + single-token step
# ---------------------------------------------------------------------------

def _cache_block_specs(cfg: ArchConfig, kind: str, batch: int, max_seq: int,
                       long: bool, dtype) -> dict:
    """ParamSpec tree of one block's decode cache (shape, axes, dtype)."""
    if kind != "attn":
        _unported(f"{cfg.name}: decode cache of block kind {kind!r}")
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
    _unported("precompute_vision_cache (VLM)")


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
    layers = [(_layer(p, r), _layer(c, r)) for r in range(cfg.repeats)
              for p, c in zip(params["pattern"], cache["pattern"])]
    layers += list(zip(params["tail"], cache["tail"]))
    for p, c in layers:
        x = _mlp(p, _dec_attn(cfg, p, x, c, pos, skv))
    return _logits(params, x), {"pattern": cache["pattern"],
                                "tail": cache["tail"], "pos": pos + 1}
