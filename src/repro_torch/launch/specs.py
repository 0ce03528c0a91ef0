"""Input and state specs of the dry run (the port of
``src/repro/launch/specs.py``): ParamSpec trees, and meta tensors made
from them, whole or a rank's blocks over a mesh.

``input_specs(cfg, shape_name)`` follows the assignment's four shapes:

    train_4k       seq=4096    global_batch=256   (training)
    prefill_32k    seq=32768   global_batch=32    (inference-prefill)
    decode_32k     seq=32768   global_batch=128   (decode: 1 token + cache)
    long_500k      seq=524288  global_batch=1     (long-context decode,
                                                   stale-KV / recurrent)

Modality stubs: VLM shapes add precomputed patch embeddings; musicgen's
tokens *are* the EnCodec frame codes (vocab 2048).  Tokens and labels
are int32, as the reference's and the port's LM pipeline's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.models.transformer import (ArchConfig, _stack_spec,
                                            arch_specs, cache_specs)
from repro_torch.nn.params import ParamSpec

Pytree = Any

SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode_long"),
}

TOKEN_DTYPE = torch.int32


def _spec(shape, axes, dtype) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init="zeros", dtype=dtype)


def shape_of(shape) -> dict:
    """A shape's ``dict(seq, batch, kind)``: a name of :data:`SHAPES`, or
    such a dict itself (another size of one of the four kinds)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def batch_logical_axes(cfg: ArchConfig, shape_name) -> dict:
    kind = shape_of(shape_name)["kind"]
    tok = ("batch", "seq")
    out = {"tokens": tok}
    if kind == "train":
        out["labels"] = tok
        out["mask"] = tok
    if cfg.vision_dim and kind in ("train", "prefill"):
        out["vision"] = ("batch", "patches", None)
    return out


def input_specs(cfg: ArchConfig, shape_name) -> dict:
    """The model inputs of one assignment shape as ParamSpecs (the
    reference's ShapeDtypeStructs, with :func:`batch_logical_axes`)."""
    sh = shape_of(shape_name)
    b, s, kind = sh["batch"], sh["seq"], sh["kind"]
    axes = batch_logical_axes(cfg, shape_name)
    if kind not in ("train", "prefill"):
        s = 1                                  # decode: ONE new token
    out = {"tokens": _spec((b, s), axes["tokens"], TOKEN_DTYPE)}
    if kind == "train":
        out["labels"] = _spec((b, s), axes["labels"], TOKEN_DTYPE)
        out["mask"] = _spec((b, s), axes["mask"], torch.float32)
    if "vision" in axes:
        out["vision"] = _spec((b, cfg.num_patches, cfg.vision_dim),
                              axes["vision"], torch.bfloat16)
    return out


def opt_state_specs(opt_name: str, param_specs: Pytree) -> Pytree:
    """The optimizer state's ParamSpec tree (``sharding.opt_state_specs``)."""
    return sharding.opt_state_specs(opt_name, param_specs)


def _map(fn, tree: Pytree) -> Pytree:
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, (list, tuple)):
        return [_map(fn, t) for t in tree]
    return {k: _map(fn, v) for k, v in tree.items()}


def train_state_specs(cfg: ArchConfig, n_pod: int = 1,
                      digest_pods: bool = False) -> dict:
    """ParamSpec tree of the whole train state (params + opt + step); with
    ``digest_pods`` and ``n_pod > 1`` every params and optimizer leaf
    carries a leading ``n_pod`` dim named "pod_stack" (the per-pod copies
    of DIGEST's local SGD)."""
    p_specs = arch_specs(cfg)
    o_specs = opt_state_specs(cfg.optimizer, p_specs)
    if digest_pods and n_pod > 1:
        def stack(s: ParamSpec) -> ParamSpec:
            return dataclasses.replace(_stack_spec(s, n_pod),
                                       axes=("pod_stack",) + s.axes)
        p_specs, o_specs = _map(stack, p_specs), _map(stack, o_specs)
    return {"params": p_specs, "opt_state": o_specs,
            "step": _spec((), (), torch.int32)}


def serve_state_specs(cfg: ArchConfig, shape_name) -> dict:
    sh = shape_of(shape_name)
    long = sh["kind"] == "decode_long"
    return {"params": arch_specs(cfg),
            "cache": cache_specs(cfg, sh["batch"], sh["seq"], long=long)}


def abstract_from_specs(specs: Pytree, mesh=None,
                        rules: Optional[dict] = None) -> Pytree:
    """Meta tensors of ``specs`` (nothing allocated): whole, or over a
    ``mesh`` this rank's blocks as ``rules`` place them
    (``sharding.placements``)."""
    if mesh is None:
        return _map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)
    sizes = sharding.mesh_sizes(mesh)
    return sharding.map_placed(
        lambda s, shape, pl: torch.empty(
            sharding.local_shape(shape, pl, sizes), dtype=s.dtype,
            device="meta"),
        sharding._spec_tree(specs),
        sharding.placements(specs, sizes, rules))
