"""Parameter specification and initialization.

A model is described by a nested tree of dicts and lists with
:class:`ParamSpec` leaves, as in the reference package; :func:`init_params`
turns it into the same tree of tensors drawn from an explicit
``torch.Generator``.  Leaves are drawn in the reference's pytree order
(dict keys sorted, lists in order), with the same lecun / normal / zeros
rules — but ``torch.Generator`` is not ``jax.random``, so the
numbers differ.  Parity tests take the reference's parameters instead,
through :func:`params_from_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

Pytree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    # Logical axis name per dim (None = replicated / unnamed dim).
    axes: tuple[Optional[str], ...]
    init: str = "lecun"  # lecun | normal | zeros | ones | embed
    dtype: torch.dtype = torch.float32
    scale: float = 1.0
    # Dims treated as fan-in for variance-scaling inits.
    fan_in_dims: tuple[int, ...] = (0,)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def _init_leaf(spec: ParamSpec, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    fan_in = max(1, int(np.prod([spec.shape[d] for d in spec.fan_in_dims])))
    if spec.init == "lecun":
        std = spec.scale * math.sqrt(1.0 / fan_in)
    elif spec.init == "normal":
        std = spec.scale * 0.02
    elif spec.init == "embed":
        std = spec.scale * 1.0
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    draw = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                       device=dev)
    return draw.mul_(std).to(spec.dtype)


def init_params(specs: Pytree, generator: torch.Generator,
                device="cuda") -> Pytree:
    """Tensor tree from a ParamSpec tree (dicts and lists, as the
    transformer's ``pattern``/``tail`` lists of stacked block dicts).
    Values are drawn from ``generator`` on its own device and then moved
    to ``device``: a CPU generator gives the same parameters on every
    device, a CUDA one draws a model too large for the host on the card
    (other numbers than the CPU's for the same seed)."""
    dev = resolve_device(device)

    def build(node):
        if isinstance(node, ParamSpec):
            return _init_leaf(node, generator).to(dev)
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return {k: build(node[k]) for k in sorted(node)}

    return build(specs)


def params_from_numpy(tree: Pytree, device="cuda") -> Pytree:
    """The reference's parameters as numpy arrays (``jax.tree.map(
    np.asarray, params)``) → the port's tensors in the same nested layout
    and shapes: GAT's ``w`` stays (din, heads, head_dim), and each leaf
    of a transformer's ``pattern`` list keeps its leading ``repeats``
    dimension (the reference's stacked layout)."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.array(node, copy=True)
        if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: exact in fp32
            return torch.from_numpy(arr.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(arr).to(dev)

    return conv(tree)


def _spec_leaves(specs: Pytree) -> list:
    if isinstance(specs, ParamSpec):
        return [specs]
    if isinstance(specs, (list, tuple)):
        return [s for v in specs for s in _spec_leaves(v)]
    return [s for v in specs.values() for s in _spec_leaves(v)]


def param_count(specs: Pytree) -> int:
    """Number of parameters of a ParamSpec tree (nothing allocated)."""
    return int(sum(math.prod(s.shape) for s in _spec_leaves(specs)))


def param_bytes(specs: Pytree) -> int:
    """Bytes of a ParamSpec tree's tensors at their dtypes."""
    return int(sum(math.prod(s.shape) * s.dtype.itemsize
                   for s in _spec_leaves(specs)))
