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

Training (:data:`TRAIN_RULES`, the reference's ``axis_rules(mesh,
{"embed": "data"})``) also cuts every ``embed`` dim over "data" (FSDP).
The train state (:func:`train_state_specs`, the reference's) places each
optimizer leaf like its parameter, Adafactor's ``row`` / ``col`` by the
axes they keep, so :func:`shard_params`, :func:`init_sharded` and
:func:`local_bytes` cover it; :func:`gather_whole` joins a rank's blocks
into the whole tree (checkpoints), and :func:`leaf_groups` names the
process group that cuts each dim of each leaf (the optimizers' whole-leaf
statistics).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence

import torch

from repro_torch.core import collectives
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

# The reference trainer's overrides (``launch/train.py``): FSDP, every
# ``embed`` dim over "data".
TRAIN_RULES: dict[str, Any] = {"embed": "data"}

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
    stay whole); :data:`WHOLE_LEAVES` whole, and every leaf under one of
    their keys (an optimizer's state of such a leaf)."""
    merged = merged_rules(rules)

    def walk(node, whole=False):
        if isinstance(node, ParamSpec):
            if whole:
                return node.shape, (None,) * len(node.shape)
            return node.shape, resolve(node.axes, merged, sizes, node.shape)
        if isinstance(node, (list, tuple)):
            return [walk(v, whole) for v in node]
        return {k: walk(v, whole or k in WHOLE_LEAVES)
                for k, v in node.items()}

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


def opt_state_specs(optimizer: str, specs: Pytree) -> Pytree:
    """The optimizer state's ParamSpec tree (the reference's
    ``launch/specs.py::opt_state_specs``): fp32 zeros, AdamW's ``m`` and
    ``v`` shaped and named as each parameter, Adafactor's ``row`` / ``col``
    with the axes of the dims they keep (``v`` for a 1-D leaf)."""
    f32 = torch.float32

    def zeros(shape, axes) -> ParamSpec:
        return ParamSpec(tuple(shape), tuple(axes), init="zeros", dtype=f32)

    def walk(fn, node):
        if isinstance(node, ParamSpec):
            return fn(node)
        if isinstance(node, (list, tuple)):
            return [walk(fn, v) for v in node]
        return {k: walk(fn, v) for k, v in node.items()}

    if optimizer in ("adam", "adamw"):
        like = lambda sp: zeros(sp.shape, sp.axes)
        return {"m": walk(like, specs), "v": walk(like, specs)}
    if optimizer == "adafactor":
        def leaf(sp):
            if len(sp.shape) >= 2:
                return {"row": zeros(sp.shape[:-1], sp.axes[:-1]),
                        "col": zeros(sp.shape[:-2] + sp.shape[-1:],
                                     sp.axes[:-2] + sp.axes[-1:])}
            return {"v": zeros(sp.shape, sp.axes)}
        return walk(leaf, specs)
    if optimizer == "sgd":
        return ()
    raise ValueError(optimizer)


def train_state_specs(specs: Pytree, optimizer: str) -> dict:
    """The train state's ParamSpec tree: ``{"params", "opt_state",
    "step"}`` (``step`` a 0-d int32)."""
    return {"params": specs, "opt_state": opt_state_specs(optimizer, specs),
            "step": ParamSpec((), (), init="zeros", dtype=torch.int32)}


def gather_whole(tree: Pytree, specs: Pytree, mesh,
                 rules: Optional[dict] = None) -> Pytree:
    """The whole tree from every rank's blocks (:func:`shard_params`'
    inverse): each placed dim gathered over its mesh dimensions, the
    minor one first, and concatenated in rank order; every rank gets the
    same bits."""
    places = placements(specs, mesh_sizes(mesh), rules)

    def whole(t, shape, placement):
        for dim, entry in enumerate(placement):
            for a in reversed(entry_names(entry)):
                if mesh.size(mesh.mesh_dim_names.index(a)) > 1:
                    t = torch.cat(collectives.all_gather(
                        t, mesh.get_group(a)), dim=dim)
        return t

    return map_placed(whole, tree, places)


@dataclasses.dataclass(frozen=True)
class LeafGroups:
    """How one leaf is cut: per dim, the mesh dimension that cuts it
    (None: whole), its process group and its size — what a statistic over
    the whole leaf adds over."""
    names: tuple
    groups: tuple
    counts: tuple

    def over(self, dims=None) -> list:
        """The groups cutting ``dims`` (every dim when None), each once,
        in dim order."""
        dims = range(len(self.names)) if dims is None else dims
        seen, out = set(), []
        for d in dims:
            if self.names[d] is not None and self.names[d] not in seen:
                seen.add(self.names[d])
                out.append(self.groups[d])
        return out

    def cut_by(self, name: str) -> bool:
        return name in self.names


def leaf_groups(specs: Pytree, mesh, rules: Optional[dict] = None
                ) -> Pytree:
    """:func:`placements`' tree as :class:`LeafGroups` leaves; a mesh
    dimension of size 1 cuts nothing, and a dim placed over two above 1
    is refused."""
    sizes = mesh_sizes(mesh)

    def leaf(spec, shape, placement):
        names = []
        for entry in placement:
            cut = [a for a in entry_names(entry) if sizes[a] > 1]
            if len(cut) > 1:
                raise ValueError(f"a parameter dim placed over {cut}: one "
                                 f"mesh dimension a dim at most")
            names.append(cut[0] if cut else None)
        return LeafGroups(tuple(names),
                          tuple(None if a is None else mesh.get_group(a)
                                for a in names),
                          tuple(1 if a is None else sizes[a]
                                for a in names))

    return map_placed(leaf, _spec_tree(specs),
                      placements(specs, sizes, rules))


def _spec_tree(specs: Pytree) -> Pytree:
    """``specs`` with lists for tuples, as :func:`map_placed` walks."""
    if isinstance(specs, ParamSpec):
        return specs
    if isinstance(specs, (list, tuple)):
        return [_spec_tree(v) for v in specs]
    return {k: _spec_tree(v) for k, v in specs.items()}
