"""The dry run's port-against-port cases (``tests/test_torch_dryrun.py``):
each case's state and inputs built on a device — real CPU tensors in the
gloo ranks of ``tests/test_torch_mesh.py::dry_census_job`` and the
world-1 runs, meta tensors in the stand-in group — and the function
whose collective census (and FLOPs) is read around one call.

The LM cases are qwen3-0.6b at its SMOKE widths over ("data", "model") =
2 x 2 (FSDP and tensor parallelism in training, tensor parallelism in
serving); the GNN case is the collective GCN epoch (round 1, pulling and
pushing) over ("pod", "data") = 2 x 2 on a small graph, 4 parts.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

LM_SHAPES = {"train": dict(seq=8, batch=4, kind="train"),
             "prefill": dict(seq=8, batch=4, kind="prefill"),
             "decode": dict(seq=16, batch=4, kind="decode")}
GNN_PARTS = 4


def lm_cfg():
    from repro_torch.configs import get_smoke_arch
    return get_smoke_arch("qwen3-0.6b")


def _tokens(shape: tuple, vocab: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, shape).astype(np.int32))


def lm_real(kind: str, mesh):
    """The real CPU run of LM case ``kind`` over ``mesh`` (None: one
    process): a function of no arguments."""
    from repro_torch.distributed import sharding
    from repro_torch.launch.dryrun import train_settings
    from repro_torch.models.transformer import (arch_specs, forward,
                                                init_cache)
    from repro_torch.nn import init_params
    from repro_torch.train.trainer import (init_train_state,
                                           make_serve_step, make_train_step)
    cfg = lm_cfg()
    sh = LM_SHAPES[kind]
    b, s = sh["batch"], sh["seq"]
    gen = torch.Generator().manual_seed(0)
    if kind == "train":
        settings = train_settings(1)
        state = init_train_state(cfg, settings, device="cpu", mesh=mesh)
        step_fn = make_train_step(cfg, settings, mesh)
        batch = {"tokens": _tokens((b, s), cfg.vocab_size, 1),
                 "labels": _tokens((b, s), cfg.vocab_size, 2),
                 "mask": torch.ones((b, s))}
        return lambda: step_fn(state, batch)
    cfg = dataclasses.replace(cfg, attn_backend="kernel")
    specs = arch_specs(cfg)
    params = (init_params(specs, gen, "cpu") if mesh is None else
              sharding.init_sharded(specs, gen, mesh, None, "cpu"))
    if kind == "prefill":
        tokens = _tokens((b, s), cfg.vocab_size, 1)

        def run():
            with torch.no_grad():
                return forward(cfg, params, tokens, mesh=mesh)
        return run
    cache = init_cache(cfg, b, s, device="cpu", mesh=mesh)
    serve = make_serve_step(cfg, mesh=mesh)
    tokens = _tokens((b, 1), cfg.vocab_size, 1)

    def run():
        with torch.no_grad():
            return serve(params, cache, tokens)
    return run


def gnn_setup():
    """(cfg, opt, settings, whole data on the CPU) of the GNN case."""
    from repro_torch.core import TrainSettings
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph.generators import sbm_graph
    from repro_torch.models.gnn import GNNConfig
    from repro_torch.optim import adam
    g = sbm_graph(256, 4)
    data = prepare_graph_data(g, GNN_PARTS, device="cpu")
    cfg = GNNConfig(model="gcn", num_layers=3, in_dim=g.features.shape[1],
                    hidden_dim=16, num_classes=4)
    settings = TrainSettings(sync_interval=10, pull_mode="collective",
                             pull_on_first_epoch=True)
    return cfg, adam(5e-3), settings, data


def gnn_run(mesh, meta: bool, collective: bool = True):
    """``(run, args, params)`` of the GNN epoch over ``mesh`` (the rank's
    parts; None with ``collective`` False: the gather epoch over all
    parts), on meta copies of the real case's tensors when ``meta``."""
    from repro_torch.core.digest import (init_state, make_epoch_fn,
                                         shard_data, shard_state)
    cfg, opt, settings, data = gnn_setup()
    if not collective:
        settings = dataclasses.replace(settings, pull_mode="gather")
    data = {k: v for k, v in data.items() if not k.startswith("_")}
    state = init_state(cfg, opt, data, precision=settings.precision)
    if mesh is not None:
        data, state = shard_data(data, mesh), shard_state(state, mesh)
    if meta:
        data, state = to_meta(data), to_meta(state)
    epoch_fn = make_epoch_fn(cfg, opt, settings, mesh)
    return (lambda: epoch_fn(state, data)), (state, data), state["params"]


def to_meta(tree):
    """``tree`` with every tensor replaced by an empty meta tensor of its
    shape and dtype."""
    if isinstance(tree, dict):
        return {k: to_meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_meta(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.empty(tree.shape, dtype=tree.dtype, device="meta")
    return tree
