"""Tensor-parallel LM serving (``repro_torch.distributed.sharding`` and
``forward`` / ``decode_step`` over a mesh's "model" dimension) against
the reference.

* ``resolve`` equals the reference's ``_resolve`` on every leaf of
  ``arch_specs`` (and of ``cache_specs``) of the ten architectures at
  their published widths (specs only, nothing allocated), over meshes
  (16, 16), (2, 16, 16), (1, 2), (2, 2) and (1, 4), under the default
  rules and under the FSDP override ``{"embed": "data"}``; the
  divisibility guard and the no-double-use cases of
  ``tests/test_sharding.py``.
* Four gloo ranks (``tests/test_torch_mesh.py::tp_job``) run each SMOKE
  config's ``forward`` and 8 ``decode_step``s, full and ``long``, over
  1 x 2, 2 x 2 and 1 x 4 meshes, on parameters drawn with numpy from a
  seed; each rank's logit block is held within 1e-5 of max |logit|
  against the reference's ``forward`` / ``decode_step`` on one device
  (a JAX subprocess beside the ranks) and against the port's single
  process; the ranks of a "model" group add the same bits; the census
  of a forward counts its ordered sums and nothing else; the
  vocab-parallel argmax, the parameter bytes and the refusals.
"""
import math
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import all_archs as jall_archs
from repro.configs import get_arch as jget_arch
from repro.distributed.sharding import DEFAULT_RULES as JRULES
from repro.distributed.sharding import _resolve
from repro.models import transformer as jt
from repro_torch.configs import get_arch, get_smoke_arch
from repro_torch.distributed import (DEFAULT_RULES, local_bytes, resolve)
from repro_torch.models import transformer as tt
from repro_torch.nn import ParamSpec

REL = 1e-5
STEPS = 8
BATCH = 4
SEQ = 8
XATTN_GATE = 0.5
ARCHS = list(jall_archs())
MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (1, 2): ("data", "model"), (2, 2): ("data", "model"),
          (1, 4): ("data", "model")}
RULES = {"default": None, "fsdp": {"embed": "data"}}
MODEL = {"1x2": 2, "2x2": 2, "1x4": 4}     # the "model" size of tp_meshes


class FakeMesh:
    """What ``_resolve`` reads of a mesh: its axis names and sizes."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.shape = dict(zip(names, shape))


def _spec_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "axes"):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def test_rules_are_the_reference_table():
    assert DEFAULT_RULES == JRULES


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_matches_reference_on_every_leaf(arch, rules):
    """Every parameter leaf (and decode cache leaf, full and ``long``) of
    the published config, under every mesh: the same entry a dim."""
    over = RULES[rules]
    jcfg, tcfg = jget_arch(arch), get_arch(arch)
    trees = [(jt.arch_specs(jcfg), tt.arch_specs(tcfg))]
    for long in (False, True):
        trees.append((jt.cache_specs(jcfg, 4, 4096, long=long),
                      tt.cache_specs(tcfg, 4, 4096, long=long)))
    merged_j = dict(JRULES, **(over or {}))
    merged_t = dict(DEFAULT_RULES, **(over or {}))
    n = 0
    for shape, names in MESHES.items():
        sizes = dict(zip(names, shape))
        for jtree, ttree in trees:
            jl, tl = _spec_leaves(jtree), _spec_leaves(ttree)
            assert len(jl) == len(tl)
            for js, ts in zip(jl, tl):
                assert tuple(js.shape) == tuple(ts.shape)
                assert tuple(js.axes) == tuple(ts.axes)
                want = tuple(_resolve(js.axes, merged_j,
                                      FakeMesh(shape, names), js.shape))
                assert resolve(ts.axes, merged_t, sizes, ts.shape) == want
                n += 1
    assert n > 40


# The guards of tests/test_sharding.py: (axes, rule overrides, shape,
# the entry of each dim), on a 16 x 16 ("data", "model") mesh.
GUARDS = [
    (("embed", "heads", "head_dim"), None, (7168, 56, 128),
     (None, None, None)),                      # 56 % 16: heads whole
    (("embed", "heads", "head_dim"), None, (7168, 64, 128),
     (None, "model", None)),
    (("embed", "mlp"), {"embed": "model"}, (4096, 16384),
     ("model", None)),                         # "model" used once
    (("batch", "seq", "embed"), None, None, ("data", None, None)),
    (("batch",), None, (32,), ("data",)),
    (("batch",), None, (8,), (None,)),        # 8 % 16: replicated
]


@pytest.mark.parametrize("axes,over,shape,want", GUARDS)
def test_resolve_guards_match_reference(axes, over, shape, want):
    mesh = FakeMesh((16, 16), ("data", "model"))
    ref = tuple(_resolve(axes, dict(JRULES, **(over or {})), mesh, shape))
    got = resolve(axes, dict(DEFAULT_RULES, **(over or {})),
                  {"data": 16, "model": 16}, shape)
    assert got == ref == tuple(want)


def test_deepseek_full_depth_bytes_a_rank():
    """deepseek-coder-33b at full depth: each rank's bytes from the
    placement (nothing allocated) — the norms whole, the rest over m —
    and its heads (56) whole at m = 16."""
    cfg = get_arch("deepseek-coder-33b")
    specs = tt.arch_specs(cfg)
    whole = local_bytes(specs, {})
    norms = sum(math.prod(s.shape) * 4 for s in _spec_leaves(specs)
                if len(s.shape) <= 2 and s.axes[-1] == "embed"
                and "vocab" not in s.axes)
    for m in (2, 4, 8):
        got = local_bytes(specs, {"data": 1, "model": m})
        assert got == norms + (whole - norms) // m, m
    # 56 heads over 16: wq, wo whole; the MLP and vocab still cut.
    assert local_bytes(specs, {"data": 1, "model": 16}) > (
        norms + (whole - norms) // 16)


# ---------------------------------------------------------------------------
# Tensor-parallel forward and decode on gloo ranks
# ---------------------------------------------------------------------------

def _numpy_params(specs, rng):
    """A parameter tree drawn with numpy by each spec's init rule (the
    scales of ``nn.init_params``), float32; ``xattn`` gates XATTN_GATE."""
    def leaf(spec: ParamSpec):
        if spec.init == "zeros":
            return np.zeros(spec.shape, np.float32)
        fan_in = max(1, math.prod(spec.shape[d] for d in spec.fan_in_dims))
        std = {"lecun": math.sqrt(1.0 / fan_in), "normal": 0.02,
               "embed": 1.0}[spec.init] * spec.scale
        return (rng.standard_normal(spec.shape) * std).astype(np.float32)

    def walk(node, key=None):
        if isinstance(node, ParamSpec):
            out = leaf(node)
            if key == "gate":
                out[...] = XATTN_GATE
            return out
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return {k: walk(node[k], k) for k in sorted(node)}

    return walk(specs)


_REF = r"""
import dataclasses, pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_arch
from repro.models import transformer as jt
with open(sys.argv[1], "rb") as f:
    data = pickle.load(f)
steps = int(sys.argv[3])
out = {}
for arch, entry in data.items():
    cfg = get_smoke_arch(arch)
    p = jax.tree.map(jnp.asarray, entry["params"])
    toks = jnp.asarray(entry["tokens"])
    vis = None if entry["vision"] is None else jnp.asarray(entry["vision"])
    res = {"forward": np.asarray(jax.jit(
        lambda p, t, v: jt.forward(cfg, p, t, v))(p, toks, vis))}
    for long in (False, True):
        c = dataclasses.replace(cfg, long_window=4, long_ratio=2) \
            if long else cfg
        cache = jt.init_cache(c, toks.shape[0], 2 * steps, long=long)
        if vis is not None:
            cache = jt.precompute_vision_cache(c, p, cache, vis)
        step = jax.jit(lambda p, ca, t, c=c, long=long: jt.decode_step(
            c, p, ca, t, long=long))
        logs = []
        for s in range(steps):
            lg, cache = step(p, cache, toks[:, s:s + 1])
            logs.append(np.asarray(lg))
        res["long" if long else "full"] = np.stack(logs)
    out[arch] = res
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def tensor_parallel(tmp_path_factory):
    """Every SMOKE config on 4 gloo ranks over the three meshes, and in
    the reference on one device (one subprocess, beside the ranks)."""
    import test_torch_mesh as tm
    tmp = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(27)
    data = {}
    for arch in ARCHS:
        cfg = get_smoke_arch(arch)
        vis = (rng.standard_normal((BATCH, cfg.num_patches, cfg.vision_dim))
               .astype(np.float32) if cfg.vision_dim else None)
        data[arch] = {
            "params": _numpy_params(tt.arch_specs(cfg), rng),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (BATCH, SEQ)).astype(np.int32),
            "vision": vis}
    inputs, ref = str(tmp / "inputs.pkl"), str(tmp / "ref.pkl")
    with open(inputs, "wb") as f:
        pickle.dump(data, f)
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(root / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REF, inputs, ref,
                             str(STEPS)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        ranks = tm.spawn("tp_job", 4, inputs=inputs, steps=STEPS)
        log, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, log
    with open(ref, "rb") as f:
        return ranks, pickle.load(f)


def _ref_block(ref: np.ndarray, key: str, res: dict) -> np.ndarray:
    r0, rows = res["rows"]
    v0, cols = res["cols"]
    sl = ref[r0:r0 + rows] if key == "forward" else ref[:, r0:r0 + rows]
    return sl[..., v0:v0 + cols]


@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_parallel_logits_match_reference(tensor_parallel, arch):
    """Each rank's logit block of ``forward`` and of 8 decode steps (full
    and ``long``) within 1e-5 of max |logit| of the reference's single
    device, and of the port's single process, over 1 x 2, 2 x 2 and
    1 x 4; the blocks tile the logits."""
    ranks, ref = tensor_parallel
    for mesh in ("1x2", "2x2", "1x4"):
        for key in ("forward", "full", "long"):
            want = ref[arch][key]
            seen = np.zeros(want.shape, bool)
            for r in ranks:
                res = r["archs"][arch][mesh]
                got = res["blocks"][key]
                blk = _ref_block(want, key, res)
                assert got.shape == blk.shape, (mesh, key)
                err = np.abs(got - blk).max() / np.abs(want).max()
                assert err < REL, (mesh, key, r["rank"], err)
                assert res["single_err"][key] < REL, (mesh, key)
                _ref_block(seen, key, res)[...] = True
            assert seen.all(), (mesh, key)


def test_tensor_parallel_model_groups_add_the_same_bits(tensor_parallel):
    """The ranks of a "model" group hold the same bits after every
    ordered sum, and a forward's census is its ordered sums (one
    ``all_gather`` each: the embedding where the vocabulary is cut, each
    row-parallel product, mLSTM's ``up`` and sLSTM's heads) and nothing
    else: 5 for a 2-layer dense SMOKE config over any mesh."""
    ranks, _ = tensor_parallel
    for arch in ARCHS:
        for mesh in ("1x2", "2x2", "1x4"):
            groups = {}
            for r in ranks:
                res = r["archs"][arch][mesh]
                # Rank (replica or data) * model + m: a group a quotient.
                groups.setdefault(r["rank"] // MODEL[mesh], []).append(res)
                assert res["model_rank"] == r["rank"] % MODEL[mesh]
                assert set(res["census"]) == {"all_gather"}, res["census"]
                if arch in ("qwen3_0_6b", "deepseek_coder_33b",
                            "minitron_8b", "musicgen_large",
                            "phi3_mini_3_8b"):
                    assert res["census"]["all_gather"] == 5
            for members in groups.values():
                assert len({tuple(m["digests"]) for m in members}) == 1, (
                    arch, mesh)
                assert len(members[0]["digests"]) >= 4


def test_vocab_argmax_and_bytes_a_rank(tensor_parallel):
    """The vocab-parallel argmax equals ``torch.argmax`` of the gathered
    logits (ties across and inside the blocks, a NaN, an all -inf row);
    each leaf a rank holds is the whole leaf over the sizes of its
    placed dimensions, and the rank holds less than the single
    process."""
    ranks, _ = tensor_parallel
    for r in ranks:
        for arch, per_mesh in r["archs"].items():
            for mesh, res in per_mesh.items():
                assert res["argmax_ok"], (arch, mesh)
                assert res["bytes_ok"], (arch, mesh)
                assert res["bytes"] < res["single_bytes"], (arch, mesh)


def test_tensor_parallel_refusals(tensor_parallel):
    """ValueError for the FSDP rule in serving (parameters over "data")
    and for query heads that read parts of several whole KV heads."""
    ranks, _ = tensor_parallel
    for r in ranks:
        assert "serving shards parameters over 'model' only" in \
            r["refusals"]["fsdp"]
        assert "KV heads" in r["refusals"]["kv heads"]


def test_init_sharded_draws_the_single_process_numbers(tensor_parallel):
    """``init_sharded`` keeps exactly ``shard_params``' blocks of the
    whole draw (contiguous), the router whole and E / model experts."""
    ranks, _ = tensor_parallel
    for r in ranks:
        for mesh, res in r["init_sharded"].items():
            assert res["equal"] and res["router_whole"], (mesh, res)
            assert res["expert_rows"] == 4 // MODEL[mesh], (mesh, res)


def test_row_parallel_bf16_product_rounds_once(tensor_parallel):
    """A bf16 row-parallel product over "model" is the whole product
    rounded once to bf16 (its fp32 partials added in fp32): within one
    bf16 ulp of it, over every mesh, where partials rounded to bf16 first
    move it by more."""
    ranks, _ = tensor_parallel
    for r in ranks:
        for mesh, res in r["row_bf16"].items():
            assert res["dtype"] == "torch.bfloat16", (mesh, res)
            assert res["ulps"] <= 1.0, (mesh, res)
            assert res["ulps_bf16_partials"] > 1.0, (mesh, res)


def test_serve_launcher_under_torchrun_on_the_cpu(tmp_path):
    """``launch/serve.py --model-axis 2 --dist-backend gloo`` under
    ``torchrun`` on the CPU: each rank prints its ms/token and its bytes
    of weights, half the single process's matrices."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--smoke", "--arch", "qwen3-0.6b", "--gen", "3",
         "--max-seq", "8", "--model-axis", "2", "--dist-backend", "gloo"],
        env=env, capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    # The two ranks' lines may share a line of the captured output.
    got = re.findall(r"rank (\d) of data 1 x model 2: [\d.]+ ms/token "
                     r"\(steady p50 [\d.]+ / p99 [\d.]+ ms\), (\d+) bytes",
                     out.stdout)
    cfg = get_smoke_arch("qwen3-0.6b")
    want = local_bytes(tt.arch_specs(cfg), {"data": 1, "model": 2})
    assert sorted(got) == [("0", str(want)), ("1", str(want))], out.stdout
