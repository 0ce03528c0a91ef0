"""The reference's logical axis rules (MaxText style) as placements of
the port's tensors over a ``DeviceMesh``.

Models name each dimension of a parameter or cache tensor with a
*logical* axis (``ParamSpec.axes``); a rule table maps logical names to
mesh dimensions.  :data:`DEFAULT_RULES` is the reference's table,
verbatim: Megatron-style tensor parallelism on "model" (``heads``,
``kv_heads``, ``mlp``, ``vocab``, ``rnn``, ``expert``), the batch over
("pod", "data").  :func:`resolve` is the reference's ``_resolve``: an
entry is dropped where its mesh dimension is absent, already used by an
earlier dim of the tensor, or does not divide the dim (deepseek's 56
heads on a 16-way "model" stay whole).

The reference hands the resolved ``PartitionSpec`` to GSPMD
(``NamedSharding``); here a rank holds its contiguous block of each
sharded dim as a plain tensor (:func:`shard_params`), and the model adds
the partial sums itself through ``core.collectives.ordered_sum``, so
every collective is counted in the census and no library kernel enters
(no DTensor).  Rules are passed explicitly: ``rules`` are overrides of
:data:`DEFAULT_RULES` (the reference's ``axis_rules(mesh, rules)``
merge), ``None`` the table itself; the port has no thread-local rule
context.

One placement departs from :func:`resolve`: the MoE router (``("embed",
"expert")``) is whole on every rank (:data:`WHOLE_LEAVES`), since
``models.moe`` routes each token over all experts on every rank (d x E
a layer, under 0.01% of llama4-scout's weights).
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.nn.params import ParamSpec, _init_leaf

Pytree = Any

# Default rules: megatron-style tensor parallelism on "model", batch over
# ("pod","data"), FSDP sharding of big params over "data".
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "embed_out": None,
    "vocab": "model",
    "mlp": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "expert": "model",
    "expert_mlp": None,
    "fsdp": "data",          # applied to the *largest* dim of big params
    "kv_seq": None,
    "patches": None,
    "rnn": "model",
    "stack": None,           # stacked-layer leading dim
    "pod_stack": "pod",      # per-pod parameter copies (DIGEST local SGD)
}

# Overrides that leave every dense leaf whole and shard only the MoE
# experts over "model": expert parallelism alone (``models.moe.moe_ep``).
EXPERT_PARALLEL_RULES: dict[str, Any] = {
    name: None for name in ("vocab", "mlp", "heads", "kv_heads", "rnn")}

# Leaves kept whole on every rank whatever their axes resolve to (module
# docstring).
WHOLE_LEAVES = frozenset({"router"})


def merged_rules(rules: Optional[dict] = None) -> dict:
    """:data:`DEFAULT_RULES` with ``rules``' overrides."""
    return dict(DEFAULT_RULES, **(rules or {}))


def mesh_sizes(mesh) -> dict:
    """``{dimension name: size}`` of a ``DeviceMesh`` in mesh order; empty
    for None."""
    if mesh is None:
        return {}
    return {name: mesh.size(i)
            for i, name in enumerate(mesh.mesh_dim_names or ())}


def resolve(axes: Sequence[Optional[str]], rules: dict, sizes: dict,
            shape: Optional[Sequence[int]] = None) -> tuple:
    """Logical axes → one entry a dim: None, a mesh dimension's name, or a
    tuple of names (the reference's ``PartitionSpec`` entries).  Drops
    mesh dimensions that are absent from ``sizes``, already used by an
    earlier dim, or — when ``shape`` is given — do not divide the dim
    size."""
    used: set[str] = set()
    spec = []
    for i, name in enumerate(axes):
        entry = rules.get(name) if name else None
        if entry is None:
            spec.append(None)
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        keep: list[str] = []
        size = None if shape is None else int(shape[i])
        for n in names:
            if n not in sizes or n in used:
                continue
            if size is not None and size % sizes[n] != 0:
                continue
            keep.append(n)
            used.add(n)
            if size is not None:
                size //= sizes[n]
        if not keep:
            spec.append(None)
        elif len(keep) == 1:
            spec.append(keep[0])
        else:
            spec.append(tuple(keep))
    return tuple(spec)


def entry_names(entry) -> tuple:
    """A resolved entry's mesh dimension names, major to minor."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def local_shape(shape: Sequence[int], placement: tuple,
                sizes: dict) -> tuple:
    """A rank's block shape of a tensor of ``shape`` placed by
    ``placement`` over a mesh of ``sizes``."""
    return tuple(n // math.prod(sizes[a] for a in entry_names(e))
                 for n, e in zip(shape, placement))


def block_index(entry, mesh) -> tuple:
    """(this rank's block, the block count) along a dim placed by
    ``entry``: row-major over its mesh dimensions, as ``NamedSharding``
    lays out a dim sharded over several."""
    idx, count = 0, 1
    for a in entry_names(entry):
        n = mesh.size(mesh.mesh_dim_names.index(a))
        idx, count = idx * n + mesh.get_local_rank(a), count * n
    return idx, count


def cut(t: torch.Tensor, shape: Sequence[int], placement: tuple, mesh,
        copy: bool = True) -> torch.Tensor:
    """This rank's contiguous block of ``t``, whole of ``shape``, along
    every placed dim; a tensor that already has the block's shape is
    returned as it is.  ``copy``: a contiguous copy, so that the whole can
    be freed; else a view."""
    want = local_shape(shape, placement, mesh_sizes(mesh))
    if tuple(t.shape) == want:
        return t
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"a tensor of shape {tuple(t.shape)} is neither "
                         f"the whole {tuple(shape)} nor this rank's "
                         f"block {want}")
    out = t
    for dim, entry in enumerate(placement):
        idx, count = block_index(entry, mesh)
        if count > 1:
            n = t.shape[dim] // count
            out = out.narrow(dim, idx * n, n)
    return out.clone(memory_format=torch.contiguous_format) if copy else out


def placements(specs: Pytree, sizes: dict, rules: Optional[dict] = None
               ) -> Pytree:
    """The tree of each ParamSpec leaf's ``(shape, placement)``: its whole
    shape and its resolved entries (the shape given, so non-dividing dims
    stay whole); :data:`WHOLE_LEAVES` whole."""
    merged = merged_rules(rules)

    def walk(node, key=None):
        if isinstance(node, ParamSpec):
            if key in WHOLE_LEAVES:
                return node.shape, (None,) * len(node.shape)
            return node.shape, resolve(node.axes, merged, sizes, node.shape)
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return {k: walk(v, k) for k, v in node.items()}

    return walk(specs)


def map_placed(fn, tree: Pytree, places: Pytree) -> Pytree:
    """``fn(leaf, shape, placement)`` over ``tree``'s leaves beside
    :func:`placements`' tree of the same layout."""
    if isinstance(tree, dict):
        return {k: map_placed(fn, v, places[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_placed(fn, v, p) for v, p in zip(tree, places)]
    return fn(tree, *places)


def shard_params(params: Pytree, specs: Pytree, mesh,
                 rules: Optional[dict] = None, copy: bool = True) -> Pytree:
    """A model's parameters (``arch_specs``' tree), whole or already this
    rank's blocks, → this rank's blocks (:func:`cut`)."""
    places = placements(specs, mesh_sizes(mesh), rules)
    return map_placed(lambda t, shape, pl: cut(t, shape, pl, mesh, copy),
                      params, places)


# A decode cache (``cache_specs``' tree) is cut the same way.
shard_cache = shard_params


def init_sharded(specs: Pytree, generator: torch.Generator, mesh,
                 rules: Optional[dict] = None, device="cuda") -> Pytree:
    """``nn.init_params(specs, generator, device)`` cut to this rank's
    blocks: every leaf is drawn whole in ``init_params``' order (the same
    numbers) and cut at once, so a rank never holds more than one whole
    leaf."""
    dev = resolve_device(device)
    places = placements(specs, mesh_sizes(mesh), rules)

    def build(node, place):
        if isinstance(node, ParamSpec):
            whole = _init_leaf(node, generator)
            out = cut(whole, *place, mesh).to(dev)
            del whole
            return out
        if isinstance(node, (list, tuple)):
            return [build(v, p) for v, p in zip(node, place)]
        return {k: build(node[k], place[k]) for k in sorted(node)}

    return build(specs, places)


def local_bytes(specs: Pytree, sizes: dict,
                rules: Optional[dict] = None) -> int:
    """The bytes a rank of a mesh of ``sizes`` holds of ``specs`` (nothing
    allocated)."""
    places = placements(specs, sizes, rules)

    def walk(node, place):
        if isinstance(node, ParamSpec):
            return math.prod(local_shape(*place, sizes)) * node.dtype.itemsize
        if isinstance(node, (list, tuple)):
            return sum(walk(v, p) for v, p in zip(node, place))
        return sum(walk(node[k], place[k]) for k in node)

    return walk(specs, places)
