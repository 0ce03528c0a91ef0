"""The port's LM transformer (dense and MoE) against the reference, on
the reference's own parameters (``params_from_numpy``) and the SMOKE
configs (fp32 activations): prefill logits for each attention backend
and MoE impl, decode logits step by step (full and stale-KV ``long``
caches), decode against the port's own forward, the stacked parameter
tree, parameter counts, and the block kinds that are not ported yet.

Tolerances: 1e-5 of max |logit| against JAX (measured ~1e-6: matrix
products of another library, sums in another order); decode against
forward 2e-2 of max |logit| and ``long`` against full 1e-4, the
reference's own bars (tests/test_decode_consistency.py).
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_arch as jget_arch
from repro.configs import get_smoke_arch as jget
from repro.models import stale_kv as jskv
from repro.models import transformer as jt
from repro.nn import init_params as jinit
from repro.nn import param_bytes as jparam_bytes
from repro.nn import param_count as jparam_count
from repro_torch.configs import ARCH_IDS, PORTED, all_archs, get_arch
from repro_torch.configs import get_smoke_arch as tget
from repro_torch.launch import serve as tserve
from repro_torch.models import stale_kv as tskv
from repro_torch.models import transformer as tt
from repro_torch.nn import (init_params, param_bytes, param_count,
                            params_from_numpy)

REL = 1e-5
MOE = ("llama4_scout_17b_a16e", "kimi_k2_1t_a32b")


@functools.lru_cache(maxsize=None)
def _model(name, **overrides):
    jcfg = dataclasses.replace(jget(name), **overrides)
    tcfg = dataclasses.replace(tget(name), **overrides)
    jp = jinit(jax.random.PRNGKey(0), jt.arch_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", ["qwen3_0_6b", "phi3_mini_3_8b",
                                  "musicgen_large", *MOE])
@pytest.mark.parametrize("jback,tback", [("chunked", "chunked"),
                                         ("dense", "dense"),
                                         ("dense", "kernel")])
def test_forward_matches_reference(name, jback, tback):
    """S = 96: one full 64-row tile of K6's plain version and a ragged
    one; JAX has no Pallas on the CPU, so the kernel backend is held to
    the dense reference.  The MoE SMOKE configs run the dropless
    ``moe_ref``."""
    jcfg, jp, tcfg, tp = _model(name)
    toks = _tokens(jcfg, 2, 96)
    want = jt.forward(dataclasses.replace(jcfg, attn_backend=jback), jp,
                      jnp.asarray(toks))
    got = tt.forward(dataclasses.replace(tcfg, attn_backend=tback), tp,
                     torch.from_numpy(toks))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("name", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_forward_capacity_path_matches_reference(name, capacity_factor):
    """The MoE SMOKE configs through ``moe_impl="ep"``: at the configs'
    1.25, which drops assignments at S = 96, and at 4.0 = E, which drops
    none."""
    jcfg, jp, tcfg, tp = _model(name, moe_impl="ep",
                                moe_capacity_factor=capacity_factor)
    toks = _tokens(jcfg, 2, 96, seed=5)
    want = jt.forward(jcfg, jp, jnp.asarray(toks))
    got = tt.forward(tcfg, tp, torch.from_numpy(toks))
    assert _rel(got.numpy(), want) < REL


@pytest.mark.parametrize("name,long", [("qwen3_0_6b", False),
                                       ("phi3_mini_3_8b", False),
                                       ("phi3_mini_3_8b", True),
                                       ("musicgen_large", False),
                                       ("llama4_scout_17b_a16e", False),
                                       ("kimi_k2_1t_a32b", False),
                                       ("kimi_k2_1t_a32b", True)])
def test_decode_step_matches_reference(name, long):
    """Per-step logits and the final cache against JAX's decode_step;
    ``long`` with window 8 / ratio 4 over 20 steps crosses pushes and
    the window."""
    over = dict(long_window=8, long_ratio=4) if long else {}
    jcfg, jp, tcfg, tp = _model(name, **over)
    B, S = 2, 20
    toks = _tokens(jcfg, B, S, seed=1)
    jc = jt.init_cache(jcfg, B, S, long=long)
    tc = tt.init_cache(tcfg, B, S, long=long, device="cpu")
    jstep = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, c, t,
                                                   long=long))
    for t in range(S):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.from_numpy(
            toks[:, t:t + 1]), long=long)
        assert _rel(tl.numpy(), jl) < REL, t
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for jleaf, tleaf in zip(jax.tree.leaves(jc["pattern"]),
                            jax.tree.leaves(tc["pattern"])):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", PORTED)
def test_decode_matches_forward(name):
    """Teacher forcing, as the reference's test_decode_matches_forward:
    the port's decode against the port's forward (kernel backend)."""
    cfg = dataclasses.replace(tget(name), attn_backend="kernel")
    params = init_params(tt.arch_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    ref = tt.forward(cfg, params, toks)
    cache = tt.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = tt.decode_step(cfg, params, cache, toks[:, t:t + 1])
        outs.append(lg)
    dec = torch.cat(outs, dim=1)
    assert float((dec - ref).abs().max() / ref.abs().max()) < 2e-2


def test_long_decode_exact_within_window():
    cfg = dataclasses.replace(tget("phi3_mini_3_8b"), long_window=32,
                              long_ratio=8)
    params = init_params(tt.arch_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    B, S = 1, 48
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=3))
    cf = tt.init_cache(cfg, B, S, device="cpu")
    cl = tt.init_cache(cfg, B, S, long=True, device="cpu")
    for t in range(S):
        lf, cf = tt.decode_step(cfg, params, cf, toks[:, t:t + 1])
        ll, cl = tt.decode_step(cfg, params, cl, toks[:, t:t + 1],
                                long=True)
        if t < cfg.long_window:
            torch.testing.assert_close(ll, lf, atol=1e-4, rtol=1e-4)
        assert bool(torch.isfinite(ll).all())


def test_stale_kv_decode_and_summaries_match_reference():
    rng = np.random.default_rng(4)
    B, H, KV, D, S = 2, 4, 2, 16, 24
    scfg = dict(max_seq=S, window=8, ratio=4)
    jcfg, tcfg = jskv.StaleKVConfig(**scfg), tskv.StaleKVConfig(**scfg)
    jc = jskv.init_stale_kv_cache(jcfg, B, KV, D, jnp.float32)
    tc = tskv.init_stale_kv_cache(tcfg, B, KV, D, torch.float32, "cpu")
    for t in range(S):
        q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
        k = rng.normal(size=(B, 1, KV, D)).astype(np.float32)
        v = rng.normal(size=(B, 1, KV, D)).astype(np.float32)
        pos = np.full((B,), t, np.int32)
        jo, jc = jskv.stale_kv_decode(jcfg, jc, *map(jnp.asarray,
                                                     (q, k, v, pos)))
        to, tc = tskv.stale_kv_decode(tcfg, tc, *map(torch.from_numpy,
                                                     (q, k, v, pos)))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5,
                                   rtol=1e-5)
    for key in jc:
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=1e-6, rtol=1e-6)
    kf = rng.normal(size=(B, 30, KV, D)).astype(np.float32)
    vf = rng.normal(size=(B, 30, KV, D)).astype(np.float32)
    for got, want in zip(
            tskv.summaries_from_full_kv(tcfg, torch.from_numpy(kf),
                                        torch.from_numpy(vf)),
            jskv.summaries_from_full_kv(jcfg, jnp.asarray(kf),
                                        jnp.asarray(vf))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["qwen3_0_6b", "deepseek_coder_33b",
                                  "llama4_scout_17b_a16e"])
def test_params_and_cache_trees_match_reference(name):
    """``params_from_numpy`` keeps the stacked LM tree leaf for leaf; the
    port's own specs, init and caches have the reference's structure,
    shapes and dtypes."""
    jcfg, jp, tcfg, tp = _model(name)
    jleaves, jdef = jax.tree.flatten(jp)
    assert isinstance(tp["pattern"], list) and tp["tail"] == []
    assert tp["pattern"][0]["wq"].shape[0] == tcfg.repeats
    tleaves = jax.tree.leaves(tp)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert np.array_equal(a.numpy(), np.asarray(b))
    mine = init_params(tt.arch_specs(tcfg), torch.Generator().manual_seed(0),
                       "cpu")
    assert jax.tree.structure(jax.tree.map(np.asarray, mine)) == jdef
    for a, b in zip(jax.tree.leaves(mine), jleaves):
        assert tuple(a.shape) == b.shape
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
    for long in (False, True):
        jcache = jt.init_cache(jcfg, 2, 16, long=long)
        tcache = tt.init_cache(tcfg, 2, 16, long=long, device="cpu")
        assert (jax.tree.structure(jax.tree.map(np.asarray, tcache))
                == jax.tree.structure(jcache))
        for a, b in zip(jax.tree.leaves(tcache), jax.tree.leaves(jcache)):
            assert tuple(a.shape) == b.shape


def test_bf16_weight_policy_matches_reference():
    cfg = dataclasses.replace(tget("qwen3_0_6b"), param_dtype="bfloat16")
    jcfg = dataclasses.replace(jget("qwen3_0_6b"), param_dtype="bfloat16")
    tspecs = jax.tree.leaves(tt.arch_specs(cfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    jspecs = jax.tree.leaves(jt.arch_specs(jcfg),
                             is_leaf=lambda x: hasattr(x, "axes"))
    assert [(s.shape, str(s.dtype).split(".")[-1]) for s in tspecs] == \
        [(s.shape, jnp.dtype(s.dtype).name) for s in jspecs]
    jp = jinit(jax.random.PRNGKey(0), jt.arch_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("name", ["kimi_k2_1t_a32b", "musicgen_large"])
def test_param_count_and_bytes_match_reference(name):
    """At the published widths (specs only, nothing allocated) and with
    the bf16 weight policy."""
    for over in ({}, {"param_dtype": "bfloat16"}):
        jcfg = dataclasses.replace(jget_arch(name), **over)
        tcfg = dataclasses.replace(get_arch(name), **over)
        assert param_count(tt.arch_specs(tcfg)) == jparam_count(
            jt.arch_specs(jcfg))
        assert param_bytes(tt.arch_specs(tcfg)) == jparam_bytes(
            jt.arch_specs(jcfg))


def test_unported_kinds_raise():
    """Every architecture and block kind not ported yet raises naming its
    ROADMAP.md §1 item (8b-8d, the parts of item 8)."""
    unported = {"recurrentgemma_9b": "8b", "xlstm_1_3b": "8c",
                "llama_3_2_vision_11b": "8d"}
    assert sorted(set(ARCH_IDS) - set(PORTED)) == sorted(unported)
    for name, item in unported.items():
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            get_arch(name)
    for name in ("kimi-k2-1t-a32b", "llama4-scout-17b-a16e",
                 "musicgen-large"):
        assert get_arch(name).name == name
    for kind, item in (("swa", "8b"), ("rec", "8b"), ("mlstm", "8c"),
                       ("slstm", "8c"), ("xattn", "8d")):
        cfg = dataclasses.replace(tget("qwen3_0_6b"), pattern=(kind,))
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tt.arch_specs(cfg)
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tt.init_cache(cfg, 1, 8, device="cpu")
        with pytest.raises(NotImplementedError, match=f"item {item}"):
            tt.forward(cfg, {}, torch.zeros((1, 4), dtype=torch.int32))
    cfg = tget("qwen3_0_6b")
    with pytest.raises(NotImplementedError, match="item 8d"):
        tt.precompute_vision_cache(cfg, {}, {}, torch.zeros(1))
    with pytest.raises(NotImplementedError, match="item 8d"):
        tt.forward(cfg, {}, torch.zeros((1, 4), dtype=torch.int32),
                   vision=torch.zeros(1))
    with pytest.raises(NotImplementedError, match="item 8f"):
        all_archs()
    with pytest.raises(ValueError, match="backend"):
        _, _, tcfg, tp = _model("qwen3_0_6b")
        tt.forward(dataclasses.replace(tcfg, attn_backend="pallas"), tp,
                   torch.zeros((1, 4), dtype=torch.int32))


def _serve_on_the_cpu(arch, long, capsys):
    argv = ["--device", "cpu", "--smoke", "--arch", arch, "--gen",
            "4", "--max-seq", "16"] + (["--long"] if long else [])
    stats = tserve.main(argv)
    assert len(stats.latencies_s) == 4
    assert "ms/token" in capsys.readouterr().out
    cfg = tserve.long_config(tget(arch)) if long else tget(arch)
    params = init_params(tt.arch_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    _, outs, cache = tserve.serve(cfg, params, 2, 16, 3, long=long,
                                  device="cpu")
    assert [tuple(o.shape) for o in outs] == [(2, 1, cfg.vocab_size)] * 3
    assert all(bool(torch.isfinite(o).all()) for o in outs)
    assert cache["pos"].tolist() == [3, 3]


@pytest.mark.parametrize("long", [False, True])
def test_serve_launcher_on_the_cpu(long, capsys):
    _serve_on_the_cpu("qwen3-0.6b", long, capsys)


@pytest.mark.parametrize("long", [False, True])
def test_serve_launcher_serves_moe_on_the_cpu(long, capsys):
    """llama4-scout's SMOKE config through the launcher, no new flag."""
    _serve_on_the_cpu("llama4-scout-17b-a16e", long, capsys)


def test_serve_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_cache(tget("qwen3_0_6b"), 1, 8)
