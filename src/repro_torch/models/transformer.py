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
effect here.  The embedding gathers differentiate through
``nn.take_rows``, whose backward gives the same bits run to run on the
CPU too.

Tensor parallelism (``forward`` / ``decode_step`` /
``precompute_vision_cache`` with ``mesh=`` a ``DeviceMesh`` whose
"model" dimension is above 1): parameters and caches are placed by the
reference's logical axis rules (``distributed.sharding``; ``rules``
overrides its ``DEFAULT_RULES``, where the reference marks activations
with ``logical_constraint``), and each rank computes with its blocks
only: Megatron-style, the column-parallel products (``wq``/``wk``/``wv``
by heads, ``w_gate``/``w_up`` and the shared expert's by ``mlp``, the
RG-LRU's projections by ``rnn``, ``lm_head`` by ``vocab``) need no
exchange, and each row-parallel one (``wo``, ``w_down``, the RG-LRU's
``w_out``, mLSTM's projections of its ``mlp`` rows) gives a partial sum,
taken in fp32, that one ``all_gather`` over "model" turns into the
whole, added in rank order and rounded once to the activation dtype
(``core.collectives.ordered_sum``): one rounding of the whole product,
as on one device and in the reference's GSPMD sum.  Which leaves are
cut comes from their resolved placement, once a block kind.  The
embedding over a cut vocabulary is the same sum (exact: one rank holds
each row).  mLSTM gathers its ``up``
columns (the [xi | gate] split runs across the blocks) and sLSTM its
heads before the whole ``w_out``.  Where "model" divides the query heads
but not the KV heads, the KV weights and cache stay whole and a rank
projects, writes and reads only the KV head its query heads share.  The
batch is cut over ("pod", "data") by the "batch" rule; the MoE blocks
run ``moe_ep`` (or the dropless ``moe_ref``) on the rank's rows with the
experts over "model" and the router whole.  The logits are the rank's
block ((rows, S, vocab block): :func:`batch_rows`, :func:`vocab_block`);
:func:`gather_logits` and :func:`vocab_argmax` join them.

Training runs ``forward``'s blocks under autograd, Megatron-style: the
row-parallel sums hand their gradient to each rank's partial, each value
every rank of "model" holds enters this rank's own work (a product with
its block of a weight, a slice of its heads) through
``collectives.sum_grad``, whose backward adds the ranks' gradients in
rank order, as do whole weights used there (the shared KV heads,
``q_norm`` / ``k_norm``, the router); the column gathers keep their
slice of the gradient.  The rules may also place parameters
over "data" (the reference's FSDP rule, ``{"embed": "data"}``): a block's
leaves cut over "data" are gathered (``collectives.fsdp_gather``) at the
block's start, inside its ``remat`` checkpoint, so the whole copies live
for one block (and are gathered again by the recomputation), and their
gradients are added over "data" in the gathers' backward.  The
trainer's rules map "batch" to None: its rows are cut already.
``decode_step`` and :func:`precompute_vision_cache` refuse placements
over "data", as the reference serves under the default rules.

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
import functools
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import collectives
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import dim_size
from repro_torch.models.attention import (NEG_INF, cross_attention,
                                          decode_attention,
                                          prefill_attention, repeat_kv)
from repro_torch.models.moe import load_balance_loss, moe_ffn
from repro_torch.models.recurrent import (mlstm_parallel, mlstm_step,
                                          rg_lru, rg_lru_step, slstm_scan)
from repro_torch.models.stale_kv import StaleKVConfig, stale_kv_decode
from repro_torch.nn import (ParamSpec, apply_rope, count_ids, dense, gelu,
                            rms_norm, take_rows)

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
# Tensor parallelism over a mesh's "model" dimension
# ---------------------------------------------------------------------------

class _Shards:
    """A rank of a mesh whose "model" dimension is above 1, for one block
    kind (None: the embedding and the head): its model group and index,
    and ``cut``, the logical axis of each of the block's leaves that
    "model" cuts, None where the leaf is whole (their resolved placement:
    :func:`_cut_leaves`)."""

    def __init__(self, mesh, rules: Optional[dict], cut: dict):
        self.mesh, self.rules, self.cut = mesh, rules, cut
        self.group = mesh.get_group("model")
        self.rank = mesh.get_local_rank("model")

    def gather(self, part: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks of a dim cut over "model", concatenated (the
        gradient's slice back to this rank)."""
        return collectives.gather_blocks(part, self.group, dim)

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, which every rank of "model" holds, where it enters this
        rank's own work: under autograd its gradient is added over the
        ranks (``collectives.sum_grad``)."""
        return collectives.sum_grad(t, self.group)


class _Fsdp:
    """The parameters a rank holds cut over "data" (the FSDP rule): its
    "data" group and, by block kind (None: the embedding, the final norm
    and the head), the dim of each leaf cut over "data" in one layer's
    view, None where the leaf is whole over "data"."""

    def __init__(self, mesh, dims: dict):
        self.group = mesh.get_group("data")
        self.dims = dims

    def gather(self, p: dict, kind: Optional[str]) -> dict:
        """``p`` (a block's leaves, or the top-level ones) with every leaf
        cut over "data" gathered whole over it."""
        dims = self.dims[kind]
        return {k: v if dims.get(k) is None
                else collectives.fsdp_gather(v, self.group, dims[k])
                for k, v in p.items()}


def _tensor_parallel(mesh) -> bool:
    """Whether ``mesh`` has a "model" dimension above 1 (else the model
    runs whole, as on one device)."""
    return mesh is not None and dim_size(mesh, "model") > 1


def _rule_keys(mesh, rules: Optional[dict]) -> tuple:
    """The mesh's sizes and the merged rules as cache keys."""
    return (tuple(sharding.mesh_sizes(mesh).items()),
            tuple(sorted(sharding.merged_rules(rules).items())))


def _shards(cfg: ArchConfig, mesh, rules: Optional[dict]
            ) -> Optional[dict]:
    """This rank's :class:`_Shards` by block kind (None: the embedding and
    the head); None without a "model" dimension above 1."""
    if not _tensor_parallel(mesh):
        return None
    cuts = _cut_leaves(cfg, *_rule_keys(mesh, rules))
    return {kind: _Shards(mesh, rules, cut) for kind, cut in cuts.items()}


def _fsdp(cfg: ArchConfig, mesh, rules: Optional[dict]) -> Optional[_Fsdp]:
    """This rank's :class:`_Fsdp`; None where no leaf is cut over a "data"
    dimension above 1."""
    if mesh is None or dim_size(mesh, "data") == 1:
        return None
    dims = _data_dims(cfg, *_rule_keys(mesh, rules))
    if not any(d is not None for kind in dims.values()
               for d in kind.values()):
        return None
    return _Fsdp(mesh, dims)


def _of(tps: Optional[dict], kind: Optional[str]) -> Optional[_Shards]:
    """``kind``'s :class:`_Shards` of :func:`_shards`' dict (None
    without tensor parallelism)."""
    return None if tps is None else tps[kind]


@functools.lru_cache(maxsize=64)
def _param_places(cfg: ArchConfig, sizes: tuple, rules: tuple):
    """The parameters' placements, over "model" and "data" only."""
    places = sharding.placements(arch_specs(cfg), dict(sizes), dict(rules))
    bad = _placed_over(places) - {"model", "data"}
    if bad:
        raise ValueError(
            f"{cfg.name}: the rules place parameters over {sorted(bad)}; "
            "the model shards parameters over 'model' and 'data' only")
    return places


def _placed_over(places) -> set:
    """The mesh dimensions any placement of ``places`` names."""
    return {n for _, pl in _leaves(places) for entry in pl
            for n in sharding.entry_names(entry)}


def _serving_params(cfg: ArchConfig, params: Pytree, mesh,
                    rules: Optional[dict]) -> Pytree:
    """:func:`_local_params` for the serving paths, which refuse
    placements over "data" (the reference serves under the default
    rules; FSDP is the trainer's)."""
    places = _param_places(cfg, *_rule_keys(mesh, rules))
    if "data" in _placed_over(places):
        raise ValueError(
            f"{cfg.name}: the rules place parameters over ['data']; "
            "serving shards parameters over 'model' only (FSDP is the "
            "trainer's)")
    return _local_params(cfg, params, mesh, rules)


def _by_kind(cfg: ArchConfig, fn, places) -> dict:
    """{block kind (None: the top level): {leaf: fn(axes, placement)}},
    a pattern leaf's logical axes and placement without its ``repeats``
    dim (one layer's view)."""
    pairs = sharding.map_placed(lambda sp, shape, pl: (sp.axes, pl),
                                arch_specs(cfg), places)

    def layer(block: dict, skip: int) -> dict:
        return {k: fn(axes[skip:], pl[skip:])
                for k, (axes, pl) in block.items()}

    out = {None: layer({k: pairs[k] for k in ("embed", "final_norm",
                                              "lm_head")}, 0)}
    out.update(zip(cfg.tail, [layer(b, 0) for b in pairs["tail"]]))
    out.update(zip(cfg.pattern, [layer(b, 1) for b in pairs["pattern"]]))
    return out


@functools.lru_cache(maxsize=64)
def _cut_leaves(cfg: ArchConfig, sizes: tuple, rules: tuple) -> dict:
    """{block kind (None: the top level): {leaf: the logical axis "model"
    cuts, or None}}, from :func:`_param_places` (a leaf takes "model" on
    one dim at most)."""
    def axis(axes, placement) -> Optional[str]:
        return next((a for a, e in zip(axes, placement)
                     if "model" in sharding.entry_names(e)), None)

    return _by_kind(cfg, axis, _param_places(cfg, sizes, rules))


@functools.lru_cache(maxsize=64)
def _data_dims(cfg: ArchConfig, sizes: tuple, rules: tuple) -> dict:
    """{block kind (None: the top level): {leaf: the dim "data" cuts in
    one layer's view, or None}}."""
    n = dict(sizes).get("data", 1)

    def dim(axes, placement) -> Optional[int]:
        return next((i for i, e in enumerate(placement)
                     if "data" in sharding.entry_names(e) and n > 1), None)

    return _by_kind(cfg, dim, _param_places(cfg, sizes, rules))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _local_params(cfg: ArchConfig, params: Pytree, mesh,
                  rules: Optional[dict]) -> Pytree:
    """This rank's blocks of ``params``: leaves already cut are kept, whole
    ones are cut as views (``sharding.shard_params`` makes the copies
    that let the whole be freed)."""
    return sharding.map_placed(
        lambda t, shape, pl: sharding.cut(t, shape, pl, mesh, False),
        params, _param_places(cfg, *_rule_keys(mesh, rules)))


def _row(tp: Optional[_Shards], leaf: str, product, x: torch.Tensor,
         w: torch.Tensor) -> torch.Tensor:
    """``product(x, w)`` of the row-parallel leaf ``w`` (``leaf``; its cut
    dim the one contracted) in ``x``'s dtype.  Where "model" cuts it, this
    rank's partial is taken in fp32 (the weights rounded to ``x``'s dtype
    first, as one device rounds them), the partials added over "model" in
    rank order (``core.collectives.ordered_sum``) and the sum rounded
    once: the single device's one rounding of the whole product, as the
    reference's GSPMD sums inside one product."""
    w = w.to(x.dtype)
    if tp is None or not tp.cut[leaf]:
        return product(x, w)
    part = product(x.float(), w.float())
    return collectives.ordered_sum(part, tp.group).to(x.dtype)


# The output projection of (B, S, heads, head_dim) over its heads.
_HEADS_OUT = functools.partial(torch.einsum, "bshk,hkd->bsd")


def batch_rows(batch: int, mesh, rules: Optional[dict] = None) -> tuple:
    """(first row, rows) of this rank's block of a global batch of
    ``batch`` rows: the "batch" rule resolved over the mesh (("pod",
    "data") by default; a dimension that does not divide the rows left
    out, so batch-1 decode is replicated).  The whole batch without a
    "model" dimension above 1."""
    if not _tensor_parallel(mesh):
        return 0, batch
    (entry,) = sharding.resolve(("batch",), sharding.merged_rules(rules),
                                sharding.mesh_sizes(mesh), (batch,))
    idx, count = sharding.block_index(entry, mesh)
    return idx * (batch // count), batch // count


def vocab_block(cfg: ArchConfig, mesh, rules: Optional[dict] = None
                ) -> tuple:
    """(offset, size) of this rank's block of the vocabulary: the columns
    of ``lm_head`` it holds and of the logits it returns.  The whole
    vocabulary where "model" does not divide it (or is absent)."""
    if not _tensor_parallel(mesh):
        return 0, cfg.vocab_size
    entry = sharding.resolve(("embed", "vocab"), sharding.merged_rules(rules),
                             sharding.mesh_sizes(mesh),
                             (cfg.d_model, cfg.vocab_size))[1]
    idx, count = sharding.block_index(entry, mesh)
    return idx * (cfg.vocab_size // count), cfg.vocab_size // count


def gather_logits(cfg: ArchConfig, logits: torch.Tensor, batch: int, mesh,
                  rules: Optional[dict] = None) -> torch.Tensor:
    """The global (batch, S, vocab) logits from every rank's block (one
    gather over "model" where the vocabulary is cut, one a batch
    dimension the rows were cut over): for callers that need the whole
    tensor.  ``logits`` as it is without a "model" dimension above 1."""
    tps = _shards(cfg, mesh, rules)
    if tps is None:
        return logits
    if tps[None].cut["lm_head"]:
        logits = tps[None].gather(logits, -1)
    return _gather_rows(mesh, logits, batch, rules)


def _gather_rows(mesh, x: torch.Tensor, batch: int,
                 rules: Optional[dict]) -> torch.Tensor:
    """The global batch from every rank's rows: the last batch dimension
    first, so each gather concatenates whole blocks of the one before."""
    (entry,) = sharding.resolve(("batch",), sharding.merged_rules(rules),
                                sharding.mesh_sizes(mesh), (batch,))
    for a in reversed(sharding.entry_names(entry)):
        if dim_size(mesh, a) > 1:
            x = torch.cat(collectives.all_gather(x, mesh.get_group(a)))
    return x


def vocab_argmax(cfg: ArchConfig, logits: torch.Tensor, batch: int, mesh,
                 rules: Optional[dict] = None) -> torch.Tensor:
    """``torch.argmax(gather_logits(...), dim=-1)`` without gathering the
    logits: each rank's (max, index) pair a row, gathered over "model"
    (one gather, the pairs packed in float64: exact for indices below
    2^53), the largest value taken, a tie to the lower index and a NaN
    before any number, as ``torch.argmax`` breaks them; then the rows
    gathered over the batch dimensions.  (batch, S) int64 on every
    rank."""
    tps = _shards(cfg, mesh, rules)
    if tps is None:
        return torch.argmax(logits, dim=-1)
    tp = tps[None]
    if tp.cut["lm_head"]:
        offset = tp.rank * logits.shape[-1]
        val, idx = torch.max(logits, dim=-1)
        # torch.max picks the first maximal index, a NaN first of all.
        pairs = torch.stack([val.double(), (idx + offset).double()])
        got = torch.stack(collectives.all_gather(pairs, tp.group))
        vals, idxs = got[:, 0], got[:, 1]
        nan = torch.isnan(vals)
        best = torch.where(nan, -1.0, vals).amax(dim=0)
        rank = torch.where(nan.any(dim=0), nan.double().argmax(dim=0),
                           (vals == best).double().argmax(dim=0))
        out = idxs.gather(0, rank[None])[0].long()
    else:
        out = torch.argmax(logits, dim=-1)
    return _gather_rows(mesh, out, batch, rules)


def _kv_slice(cfg: ArchConfig, p: dict, tp: Optional[_Shards]):
    """(first, count) of the KV heads this rank's query heads read where
    the KV weights are whole but the query heads cut ("model" divides
    ``heads`` but not ``kv_heads``: head h reads KV head h // rep); None
    otherwise."""
    if tp is None or not tp.cut["wq"] or tp.cut["wk"]:
        return None
    h_loc = p["wq"].shape[-2]
    rep = cfg.num_heads // cfg.num_kv_heads
    if rep % h_loc:
        raise ValueError(
            f"{cfg.name}: {h_loc} query heads a rank read parts of "
            f"several of the {cfg.num_kv_heads} whole KV heads (rep {rep})")
    return tp.rank * h_loc // rep, 1


def _kv_view(cache: dict, sl) -> dict:
    """The cache's tensors narrowed to the KV heads ``sl`` (views: writes
    land in the whole cache); the cache itself where ``sl`` is None."""
    if sl is None:
        return cache
    return {k: v.narrow(-2, sl[0], sl[1]) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# Block forward (prefill)
# ---------------------------------------------------------------------------

def _qkv(cfg: ArchConfig, p: dict, h: torch.Tensor,
         positions: torch.Tensor, tp: Optional[_Shards] = None) -> tuple:
    """Q, K and V of this rank's heads (every head without a mesh)."""
    wk, wv = p["wk"], p["wv"]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    if tp is not None and (tp.cut["wq"] or tp.cut["wk"]):
        h = tp.enter(h)
        if cfg.qk_norm:
            q_norm, k_norm = tp.enter(q_norm), tp.enter(k_norm)
    sl = _kv_slice(cfg, p, tp)
    if sl is not None:
        wk, wv = tp.enter(wk).narrow(-2, *sl), tp.enter(wv).narrow(-2, *sl)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k = torch.einsum("bsd,dhk->bshk", h, wk.to(h.dtype))
    v = torch.einsum("bsd,dhk->bshk", h, wv.to(h.dtype))
    if cfg.qk_norm:
        q = rms_norm(q, q_norm)
        k = rms_norm(k, k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_out(cfg: ArchConfig, p: dict, attn: torch.Tensor,
              x: torch.Tensor, tp: Optional[_Shards] = None
              ) -> torch.Tensor:
    """x + the output projection of this rank's heads, summed over
    "model" where the heads are cut."""
    return x + _row(tp, "wo", _HEADS_OUT, attn, p["wo"])


def _swiglu(h: torch.Tensor, p: dict, tp: Optional[_Shards],
            prefix: str = "w") -> torch.Tensor:
    """SwiGLU of rms-normed ``h`` through ``p``'s ``{prefix}_gate``,
    ``_up`` and ``_down`` (the MLP's; "ws" the shared expert's): this
    rank's ``mlp`` columns where they are cut, its ``_down`` rows then
    row-parallel (:func:`_row`)."""
    if tp is not None and tp.cut[f"{prefix}_gate"]:
        h = tp.enter(h)
    a = F.silu(dense(h, p[f"{prefix}_gate"].to(h.dtype))) \
        * dense(h, p[f"{prefix}_up"].to(h.dtype))
    return _row(tp, f"{prefix}_down", dense, a, p[f"{prefix}_down"])


def _mlp(cfg: ArchConfig, p: dict, x: torch.Tensor,
         tp: Optional[_Shards] = None) -> torch.Tensor:
    """x + the SwiGLU MLP of rms_norm(x)."""
    return x + _swiglu(rms_norm(x, p["ln2"]), p, tp)


def _moe(cfg: ArchConfig, p: dict, x: torch.Tensor, mesh=None,
         tp: Optional[_Shards] = None) -> torch.Tensor:
    """x + the MoE FFN of rms_norm(x) (+ the shared expert); ``mesh``:
    the ``DeviceMesh`` the experts are sharded over (``moe_ep``, or the
    dropless ``moe_ref``).  Under tensor parallelism ``x`` holds this
    rank's rows and the shared expert is cut over ``mlp``."""
    h2 = rms_norm(x, p["ln2"])
    moe_params = {"router": p["router"], "w_gate": p["w_gate_e"],
                  "w_up": p["w_up_e"], "w_down": p["w_down_e"]}
    kw = {} if tp is None else {"batch_axes": ()}
    h_in = h2
    if tp is not None:
        # Each rank runs its experts: the tokens and the whole router
        # enter its own work.
        h_in = tp.enter(h2)
        moe_params["router"] = tp.enter(p["router"])
    out = moe_ffn(h_in, moe_params, cfg.experts_per_token,
                  impl=cfg.moe_impl, capacity_factor=cfg.moe_capacity_factor,
                  mesh=mesh, **kw)
    if cfg.shared_expert:
        out = out + _swiglu(h2, p, tp, "ws")
    return x + out


def _ffn(cfg: ArchConfig, kind: str, p: dict, x: torch.Tensor,
         ctx: dict) -> torch.Tensor:
    """An attention block's second half: the MoE of "moe", else the
    MLP."""
    if kind == "moe":
        return _moe(cfg, p, x, ctx["mesh"], ctx["tp"])
    return _mlp(cfg, p, x, ctx["tp"])


def _fwd_attn(cfg, kind, p, x, ctx):
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, ctx["positions"], ctx["tp"])
    attn = prefill_attention(q, k, v,
                             window=cfg.window if kind == "swa" else 0,
                             backend=cfg.attn_backend)
    return _ffn(cfg, kind, p, _attn_out(cfg, p, attn, x, ctx["tp"]), ctx)


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in fp32. x: (B, S, D); w: (W, D)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(w.shape[0]):
        shifted = F.pad(x, (0, 0, i, 0))[:, :x.shape[1]]
        out = out + shifted.float() * w[i].float()
    return out.to(x.dtype)


def _fwd_rec(cfg, kind, p, x, ctx):
    """The RG-LRU block: its ``rnn`` channels cut over "model" (the scan
    is elementwise in them), ``w_out`` row-parallel."""
    tp = ctx["tp"]
    h = rms_norm(x, p["ln1"])
    if tp is not None and tp.cut["w_y"]:
        h = tp.enter(h)
    y = gelu(dense(h, p["w_y"].to(h.dtype)))
    bx = _conv1d_causal(dense(h, p["w_x"].to(h.dtype)), p["conv_w"])
    gx = dense(h, p["w_gate_x"].to(h.dtype))
    ga = dense(h, p["w_gate_a"].to(h.dtype))
    lru, _ = rg_lru(bx, gx, ga, p["log_lambda"])
    return _mlp(cfg, p, x + _row(tp, "w_out", dense, y * lru, p["w_out"]),
                tp)


def _mlstm_in(cfg: ArchConfig, p: dict, h: torch.Tensor,
              tp: Optional[_Shards], lhs: str, out: str) -> tuple:
    """The mLSTM block's projections of rms_norm(x) ``h`` (einsum
    subscripts ``lhs``, i/f laid out as ``out``, q/k/v as ``out`` + "k":
    "bsd" / "bhs" in prefill, "bd" / "bh" in decode): (q, k, v, i_pre,
    f_pre, gate) of this rank's heads (every head where ``heads`` is
    whole).  Under tensor parallelism ``w_up``'s ``mlp`` columns are
    gathered (the [xi | gate] split runs across the blocks); where the
    projections' ``mlp`` rows are cut, their products of this rank's rows
    of ``xi`` are row-parallel (:func:`_row`'s rounding, the five summed
    in one gather)."""
    if tp is not None and tp.cut["w_up"]:
        up = tp.gather(dense(tp.enter(h), p["w_up"].to(h.dtype)), -1)
    else:
        up = dense(h, p["w_up"].to(h.dtype))
    di = cfg.mlstm_expansion * cfg.d_model
    xi, gate = up[..., :di], up[..., di:]
    ws = [p[w].to(xi.dtype) for w in ("wq", "wk", "wv", "w_i", "w_f")]
    rows_cut = tp is not None and tp.cut["wq"] == "mlp"
    if tp is not None and tp.cut["wq"]:
        xi = tp.enter(xi)
    if rows_cut:
        rows = ws[0].shape[0]
        xi = xi.narrow(-1, tp.rank * rows, rows).float()
        ws = [w.float() for w in ws]
    q, k, v = (torch.einsum(f"{lhs},dhk->{out}k", xi, w) for w in ws[:3])
    i_pre, f_pre = (torch.einsum(f"{lhs},dh->{out}", xi, w)
                    for w in ws[3:])
    if rows_cut:
        hd = q.shape[-1]
        packed = torch.cat([q, k, v, i_pre[..., None], f_pre[..., None]],
                           dim=-1)
        packed = collectives.ordered_sum(packed, tp.group).to(h.dtype)
        q, k, v = packed[..., :hd], packed[..., hd:2 * hd], \
            packed[..., 2 * hd:3 * hd]
        i_pre, f_pre = packed[..., 3 * hd], packed[..., 3 * hd + 1]
    h_loc = _mlstm_heads(cfg, tp)
    if h_loc < cfg.num_heads:
        # This rank's heads: the cache's ``heads`` block (the projections
        # give no others where "model" cuts their heads).
        if tp.cut["wq"] != "heads":
            at = out.index("h")
            q, k, v, i_pre, f_pre = (
                tp.enter(t).narrow(at, tp.rank * h_loc, h_loc)
                for t in (q, k, v, i_pre, f_pre))
        gate = tp.enter(gate).narrow(
            -1, tp.rank * h_loc * (di // cfg.num_heads),
            h_loc * (di // cfg.num_heads))
    return q, k, v, i_pre, f_pre, gate


def _mlstm_heads(cfg: ArchConfig, tp: Optional[_Shards]) -> int:
    """The mLSTM heads a rank runs: its block of the state's ``heads``
    dim (``cache_specs``' placement), every head where "model" leaves it
    whole."""
    if tp is None:
        return cfg.num_heads
    (entry,) = sharding.resolve(("heads",), sharding.merged_rules(tp.rules),
                                sharding.mesh_sizes(tp.mesh),
                                (cfg.num_heads,))
    return cfg.num_heads // sharding.block_index(entry, tp.mesh)[1]


def _mlstm_out(cfg: ArchConfig, p: dict, core: torch.Tensor,
               gate: torch.Tensor, tp: Optional[_Shards]) -> torch.Tensor:
    """The gated core (this rank's heads' channels) through ``w_down``,
    row-parallel where its ``mlp`` rows are cut (:func:`_row`).  Where
    "model" cuts one of the two only, the channels are first made
    ``w_down``'s rows: gathered, or this rank's block taken."""
    z = core * F.silu(gate)
    if tp is not None:
        heads_cut = _mlstm_heads(cfg, tp) < cfg.num_heads
        if heads_cut and not tp.cut["w_down"]:
            z = tp.gather(z, -1)
        elif tp.cut["w_down"] and not heads_cut:
            rows = p["w_down"].shape[0]
            z = tp.enter(z).narrow(-1, tp.rank * rows, rows)
    return _row(tp, "w_down", dense, z, p["w_down"])


def _fwd_mlstm(cfg, kind, p, x, ctx):
    tp = ctx["tp"]
    h = rms_norm(x, p["ln1"])
    q, k, v, i_pre, f_pre, gate = _mlstm_in(cfg, p, h, tp, "bsd", "bhs")
    b, s, _ = h.shape
    core = mlstm_parallel(q, k, v, i_pre, f_pre)           # (B, H, S, dh)
    core = core.transpose(1, 2).reshape(b, s, -1)
    return x + _mlstm_out(cfg, p, core, gate, tp)


def _fwd_slstm(cfg, kind, p, x, ctx, state: Optional[dict] = None):
    """The sLSTM block over (B, S, d) from ``state`` (zeros when None):
    this rank's heads (cut over "model"; the recurrence is per head),
    gathered before the whole ``w_out``.  Returns (new x, the final
    state)."""
    tp = ctx["tp"]
    h = rms_norm(x, p["ln1"])
    if tp is not None and tp.cut["w_in"]:
        h = tp.enter(h)
    wx = torch.einsum("bsd,dhgk->bshgk", h, p["w_in"].to(h.dtype))
    hs, state = slstm_scan(wx, {g: p[f"r_{g}"] for g in "zifo"}, state)
    if tp is not None and tp.cut["w_in"]:
        hs = tp.gather(hs, 2)
    b, s = h.shape[:2]
    x = x + dense(hs.reshape(b, s, -1), p["w_out"].to(h.dtype))
    return _mlp(cfg, p, x, tp), state


def _xattn(cfg: ArchConfig, p: dict, x: torch.Tensor, q: torch.Tensor,
           k: torch.Tensor, v: torch.Tensor,
           tp: Optional[_Shards]) -> torch.Tensor:
    """x + tanh(gate) * the cross-attention's output (the product in
    fp32, as the reference's fp32 gate promotes it; this rank's heads
    summed over "model" first), then the MLP."""
    out = _row(tp, "wo", _HEADS_OUT, cross_attention(q, k, v), p["wo"])
    gate = torch.tanh(p["gate"].float())[0]
    return _mlp(cfg, p, x + (gate * out.float()).to(x.dtype), tp)


def _vision_kv(cfg: ArchConfig, p: dict, vis: torch.Tensor, eq: str,
               tp: Optional[_Shards]) -> tuple:
    """The vision K/V of this rank's KV heads (``eq`` the einsum)."""
    wk, wv = p["wk"], p["wv"]
    sl = _kv_slice(cfg, p, tp)
    if sl is not None:
        wk, wv = tp.enter(wk).narrow(-2, *sl), tp.enter(wv).narrow(-2, *sl)
    return (torch.einsum(eq, vis, wk.to(vis.dtype)),
            torch.einsum(eq, vis, wv.to(vis.dtype)))


def _fwd_xattn(cfg, kind, p, x, ctx):
    vis = ctx["vision"]
    if vis is None:
        raise ValueError(f"{cfg.name}: xattn blocks need a vision input")
    h = rms_norm(x, p["ln1"])
    tp = ctx["tp"]
    if tp is not None and tp.cut["wq"]:
        h = tp.enter(h)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    k, v = _vision_kv(cfg, p, vis.to(h.dtype), "bpv,vhk->bphk", tp)
    return _xattn(cfg, p, x, q, k, v, ctx["tp"])


_FWD = {"attn": _fwd_attn, "swa": _fwd_attn, "moe": _fwd_attn,
        "rec": _fwd_rec, "mlstm": _fwd_mlstm,
        "slstm": lambda *a: _fwd_slstm(*a)[0], "xattn": _fwd_xattn}


def _fwd_block(cfg, kind, p, x, ctx):
    """One block; ``ctx["tp"]`` its kind's :class:`_Shards`; its leaves
    cut over "data" gathered first (``ctx["fsdp"]``)."""
    if kind not in _FWD:
        raise ValueError(kind)
    if ctx.get("fsdp") is not None:
        p = ctx["fsdp"].gather(p, kind)
    return _FWD[kind](cfg, kind, p, x,
                      dict(ctx, tp=_of(ctx["shards"], kind)))


def _layer(tree: dict, r: int) -> dict:
    """Repeat ``r`` of a stacked block dict (views, no copy)."""
    return {k: v[r] for k, v in tree.items()}


def _repeat(cfg: ArchConfig, pattern: list, r: int, x: torch.Tensor,
            ctx: dict) -> torch.Tensor:
    """Repeat ``r`` of the pattern's blocks (the reference's scan body)."""
    for kind, block in zip(cfg.pattern, pattern):
        x = _fwd_block(cfg, kind, _layer(block, r), x, ctx)
    return x


def _lookup(table: torch.Tensor, tokens: torch.Tensor,
            tp: Optional[_Shards], dtype: torch.dtype) -> torch.Tensor:
    """The embedding rows of ``tokens`` in ``dtype``.  Where the vocabulary
    is cut over "model", each rank looks up the tokens of its block,
    writes zeros for the rest and the blocks are summed: exact, one rank
    gives each row."""
    if tp is not None and tp.cut["embed"]:
        local = tokens.long() - tp.rank * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        rows = take_rows(table, torch.where(mine, local, 0)).to(dtype)
        return collectives.ordered_sum(
            torch.where(mine[..., None], rows, 0.0).to(dtype), tp.group)
    return take_rows(table, tokens.long()).to(dtype)


def _embed(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
           tp: Optional[_Shards] = None) -> torch.Tensor:
    """The scaled token embeddings (:func:`_lookup`)."""
    dt = cfg.act_dtype
    x = _lookup(params["embed"], tokens, tp, dt)
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)


def _logits(params: Pytree, x: torch.Tensor,
            tp: Optional[_Shards] = None) -> torch.Tensor:
    x = rms_norm(x, params["final_norm"])
    if tp is not None and tp.cut["lm_head"]:
        x = tp.enter(x)
    return torch.matmul(x.float(), params["lm_head"].float())


def _top(params: Pytree, keys: tuple, fs: Optional[_Fsdp]) -> dict:
    """The top-level leaves ``keys``, gathered over "data" where cut."""
    top = {k: params[k] for k in keys}
    return top if fs is None else fs.gather(top, None)


def forward(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
            vision: Optional[torch.Tensor] = None, mesh=None,
            rules: Optional[dict] = None) -> torch.Tensor:
    """tokens: (B, S) int → logits (B, S, vocab) f32.  ``vision``: the
    (B, num_patches, vision_dim) patch embeddings ``xattn`` blocks
    attend to, cast to the activation dtype.

    ``mesh``: a ``DeviceMesh``.  With a "model" dimension above 1 the
    model is tensor-parallel by ``rules`` (overrides of
    ``distributed.sharding.DEFAULT_RULES``; module docstring): ``tokens``
    and ``vision`` are the global batch on every rank, ``params`` whole
    or this rank's blocks (``sharding.shard_params``), and the rank
    returns its block of the logits, (rows, S, vocab block) at
    :func:`batch_rows` and :func:`vocab_block` (:func:`gather_logits`
    joins them).  Otherwise the mesh only shards the MoE blocks'
    experts (``moe_ep``) and the logits are global.  Rules that place
    parameters over "data" (FSDP) gather each block's such leaves over it
    (module docstring); rules that map "batch" to None (the trainer's)
    take ``tokens`` and ``vision`` as this rank's rows."""
    tps = _shards(cfg, mesh, rules)
    fs = _fsdp(cfg, mesh, rules)
    if tps is not None or fs is not None:
        params = _local_params(cfg, params, mesh, rules)
    if tps is not None:
        r0, rows = batch_rows(tokens.shape[0], mesh, rules)
        tokens = tokens[r0:r0 + rows]
        vision = None if vision is None else vision[r0:r0 + rows]
    x = _embed(cfg, _top(params, ("embed",), fs), tokens, _of(tps, None))
    ctx = {"positions": torch.arange(tokens.shape[1], device=x.device),
           "vision": None if vision is None else vision.to(x.dtype),
           "mesh": mesh, "shards": tps, "fsdp": fs}
    remat = cfg.remat and torch.is_grad_enabled()
    for r in range(cfg.repeats):
        if remat:
            x = checkpoint(_repeat, cfg, params["pattern"], r, x, ctx,
                           use_reentrant=False)
        else:
            x = _repeat(cfg, params["pattern"], r, x, ctx)
    for kind, block in zip(cfg.tail, params["tail"]):
        x = _fwd_block(cfg, kind, block, x, ctx)
    return _logits(_top(params, ("final_norm", "lm_head"), fs), x,
                   _of(tps, None))


def _token_rows(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                mesh, rules: Optional[dict]) -> torch.Tensor:
    """The unscaled fp32 embedding rows of ``tokens``, (T, d): over a
    sharded mesh (the trainer's placements) the table is gathered over
    "data" and looked up over its vocabulary blocks (:func:`_lookup`)."""
    fs = _fsdp(cfg, mesh, rules)
    tp = _of(_shards(cfg, mesh, rules), None)
    table = _top(params, ("embed",), fs)["embed"]
    return _lookup(table, tokens, tp, torch.float32).reshape(-1, cfg.d_model)


def aux_moe_loss(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                 x_embed: Optional[torch.Tensor] = None, mesh=None,
                 rules: Optional[dict] = None) -> torch.Tensor:
    """Router load-balance loss, from the first repeat's router of each
    MoE block of the pattern, on the unscaled fp32 token embeddings (the
    reference's; ``x_embed`` is unused there too).  ``mesh``, ``rules``:
    the trainer's sharded parameters (:func:`forward`'s)."""
    if cfg.num_experts == 0:
        return torch.zeros((), device=params["embed"].device)
    x = _token_rows(cfg, params, tokens, mesh, rules)
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


def aux_moe_stats(cfg: ArchConfig, params: Pytree, tokens: torch.Tensor,
                  mesh=None, rules: Optional[dict] = None) -> list:
    """:func:`aux_moe_loss`'s sums over ``tokens``, one pair a MoE block
    of the pattern: (top-1 dispatch counts (E,), router probability sums
    (E,)), fp32 — what a data-parallel step adds over its ranks before
    the product."""
    x = _token_rows(cfg, params, tokens, mesh, rules)
    out = []
    for kind, block in zip(cfg.pattern, params["pattern"]):
        if kind != "moe":
            continue
        logits = x @ block["router"][0].float()
        ids = torch.topk(logits, cfg.experts_per_token, dim=-1).indices
        counts = count_ids(ids[:, 0], cfg.num_experts)
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
               long: bool = False, device="cuda", mesh=None,
               rules: Optional[dict] = None) -> dict:
    """Zeros of :func:`cache_specs` (mLSTM's ``m`` starts at 0, as the
    reference's does): over a ``mesh`` with a "model" dimension above 1,
    this rank's blocks of them (``batch`` the global batch), as
    ``sharding.shard_cache`` would cut the whole cache."""
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, max_seq, long)
    if not _tensor_parallel(mesh):
        return _map_specs(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev), specs)
    sizes = sharding.mesh_sizes(mesh)
    return sharding.map_placed(
        lambda s, shape, pl: torch.zeros(
            sharding.local_shape(shape, pl, sizes), dtype=s.dtype,
            device=dev),
        specs, sharding.placements(specs, sizes, rules))


def _dec_attn(cfg, p, x, cache, pos, skv: Optional[StaleKVConfig], tp):
    """x: (B, 1, d) through one attention block's attention against its
    cache — the stale-KV ``long`` cache when ``skv`` is given — which is
    updated in place (the heads this rank reads).  Returns the new x."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, pos[:, None], tp)
    cache = _kv_view(cache, _kv_slice(cfg, p, tp))
    if skv is not None:
        attn, _ = stale_kv_decode(skv, cache, q, k, v, pos)
    else:
        slot = pos[:1].long()
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        attn = decode_attention(q, cache["k"], cache["v"], pos)
    return _attn_out(cfg, p, attn, x, tp)


def _dec_swa(cfg, p, x, cache, pos, tp):
    """A ``swa`` block's attention over its ring (row ``pos % window``
    takes the new K/V in place), masked by each row's absolute position
    as the reference masks it."""
    h = rms_norm(x, p["ln1"])
    q, k, v = _qkv(cfg, p, h, pos[:, None], tp)
    cache = _kv_view(cache, _kv_slice(cfg, p, tp))
    slot = pos[:1].long() % cfg.window
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    ring = cache["k"].shape[1]
    idx = torch.arange(ring, device=x.device)
    p0 = pos[:1].long()
    abs_pos = torch.where(idx <= slot, p0 - slot + idx,
                          p0 - slot + idx - ring)
    rep = q.shape[2] // k.shape[2]
    q32 = q[:, 0].float() * cfg.hd ** -0.5
    kf = repeat_kv(cache["k"], rep).float()
    vf = repeat_kv(cache["v"], rep).float()
    logits = torch.einsum("bhd,bshd->bhs", q32, kf)
    mask = (abs_pos >= 0) & (abs_pos <= p0)
    logits = torch.where(mask[None, None, :], logits, NEG_INF)
    pa = torch.softmax(logits, dim=-1)
    attn = torch.einsum("bhs,bshd->bhd", pa, vf)[:, None].to(q.dtype)
    return _attn_out(cfg, p, attn, x, tp)


def _dec_rec(cfg, p, x, cache, tp):
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
    out = _row(tp, "w_out", torch.matmul, y * lru, p["w_out"])
    return _mlp(cfg, p, x + out[:, None], tp)


def _dec_mlstm(cfg, p, x, cache, tp):
    h = rms_norm(x, p["ln1"])[:, 0]
    q, k, v, i_pre, f_pre, gate = _mlstm_in(cfg, p, h, tp, "bd", "bh")
    core, state = mlstm_step(q, k, v, i_pre, f_pre, cache)
    for key, val in state.items():
        cache[key].copy_(val)
    core = core.reshape(core.shape[0], -1).to(h.dtype)
    return x + _mlstm_out(cfg, p, core, gate, tp)[:, None]


def _dec_slstm(cfg, p, x, cache, tp):
    x, state = _fwd_slstm(cfg, "slstm", p, x, {"tp": tp}, state=cache)
    for key, val in state.items():
        cache[key].copy_(val)
    return x


def _dec_xattn(cfg, p, x, cache, tp):
    h = rms_norm(x, p["ln1"])
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"].to(h.dtype))
    cache = _kv_view(cache, _kv_slice(cfg, p, tp))
    return _xattn(cfg, p, x, q, cache["k"], cache["v"], tp)


def _dec_block(cfg, kind, p, x, cache, pos, skv, ctx):
    """One block of a decode step; its cache is updated in place."""
    tp = _of(ctx["shards"], kind)
    ctx = dict(ctx, tp=tp)
    if kind in ("attn", "moe"):
        return _ffn(cfg, kind, p,
                    _dec_attn(cfg, p, x, cache, pos, skv, tp), ctx)
    if kind == "swa":
        return _mlp(cfg, p, _dec_swa(cfg, p, x, cache, pos, tp), tp)
    if kind == "rec":
        return _dec_rec(cfg, p, x, cache, tp)
    if kind == "mlstm":
        return _dec_mlstm(cfg, p, x, cache, tp)
    if kind == "slstm":
        return _dec_slstm(cfg, p, x, cache, tp)
    if kind == "xattn":
        return _dec_xattn(cfg, p, x, cache, tp)
    raise ValueError(kind)


def _local_cache(cache: dict, rows: int) -> None:
    """ValueError unless ``cache`` holds this rank's ``rows`` rows."""
    if cache["pos"].shape[0] != rows:
        raise ValueError(
            f"the cache holds {cache['pos'].shape[0]} rows, this rank "
            f"{rows}: over a mesh decode takes this rank's cache "
            f"(init_cache(..., mesh=) or sharding.shard_cache)")


def precompute_vision_cache(cfg: ArchConfig, params: Pytree, cache: dict,
                            vision: torch.Tensor, mesh=None,
                            rules: Optional[dict] = None) -> dict:
    """Fill the ``xattn`` blocks' cache (in place) with the vision K/V,
    every repeat projected at once (the reference's ``"bpv,rvhk->rbphk"``).
    ``vision``: (B, num_patches, vision_dim), cast to the activation
    dtype.  ``mesh`` and ``rules`` as :func:`forward`'s: ``vision`` is the
    global batch, the cache this rank's, filled for its KV heads.
    Returns the cache."""
    tps = _shards(cfg, mesh, rules)
    tp = _of(tps, "xattn") if "xattn" in cfg.pattern else None
    if tps is not None:
        params = _serving_params(cfg, params, mesh, rules)
        r0, rows = batch_rows(vision.shape[0], mesh, rules)
        _local_cache(cache, rows)
        vision = vision[r0:r0 + rows]
    vis = vision.to(cfg.act_dtype)
    for kind, p, entry in zip(cfg.pattern, params["pattern"],
                              cache["pattern"]):
        if kind == "xattn":
            k, v = _vision_kv(cfg, p, vis, "bpv,rvhk->rbphk", tp)
            entry = _kv_view(entry, _kv_slice(cfg, p, tp))
            entry["k"].copy_(k)
            entry["v"].copy_(v)
    return cache


def decode_step(cfg: ArchConfig, params: Pytree, cache: dict,
                tokens: torch.Tensor, long: bool = False, mesh=None,
                rules: Optional[dict] = None) -> tuple:
    """tokens: (B, 1) → (logits (B, 1, vocab), cache).  The cache's
    tensors are updated in place; the returned dict holds them and
    ``pos + 1``.  ``long``: attention blocks read the stale-KV cache,
    sized from the first attention block of the pattern (none: the
    pattern has no such block, and ``long`` changes nothing).  ``mesh``
    and ``rules`` as :func:`forward`'s: ``tokens`` the global batch, the
    cache this rank's (:func:`init_cache` with the mesh, or
    ``sharding.shard_cache``), the logits its block."""
    tps = _shards(cfg, mesh, rules)
    if tps is not None:
        params = _serving_params(cfg, params, mesh, rules)
        r0, rows = batch_rows(tokens.shape[0], mesh, rules)
        _local_cache(cache, rows)
        tokens = tokens[r0:r0 + rows]
    x = _embed(cfg, params, tokens, _of(tps, None))
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
    ctx = {"mesh": mesh, "shards": tps}
    for kind, p, c in layers:
        x = _dec_block(cfg, kind, p, x, c, pos, skv, ctx)
    return _logits(params, x), {"pattern": cache["pattern"],
                                "tail": cache["tail"], "pos": pos + 1}
