"""The port's LM transformer (all ten architectures) against the
reference, on the reference's own parameters (``params_from_numpy``) and
the SMOKE configs (fp32 activations): prefill logits for each attention
backend and MoE impl, decode logits and every cache state step by step
(full and stale-KV ``long`` caches; recurrentgemma past its window, so
the ``swa`` ring wraps), decode against the port's own forward, the
stacked parameter tree, parameter counts, the config registry and the
parts that are not ported yet.  ``xattn`` gates are zero at init
(``tanh(0)`` adds nothing), so every test of the VLM sets them to 0.5
in the reference's parameters before either package reads them, and
feeds a vision input from a seed.

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
NEW = ("recurrentgemma_9b", "xlstm_1_3b", "llama_3_2_vision_11b")
XATTN_GATE = 0.5


@pytest.fixture(autouse=True)
def _one_thread():
    """The SMOKE models' ops are small: one intra-op thread runs them
    about as fast alone, and far faster beside other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _open_gates(tree):
    """The parameter tree with every ``xattn`` gate set to XATTN_GATE
    (numpy leaves, a copy)."""
    tree = jax.tree.map(np.array, tree)
    for block in [*tree["pattern"], *tree["tail"]]:
        if "gate" in block:
            block["gate"][...] = XATTN_GATE
    return tree


@functools.lru_cache(maxsize=None)
def _model(name, **overrides):
    jcfg = dataclasses.replace(jget(name), **overrides)
    tcfg = dataclasses.replace(tget(name), **overrides)
    host = _open_gates(jinit(jax.random.PRNGKey(0), jt.arch_specs(jcfg)))
    jp = jax.tree.map(jnp.asarray, host)
    tp = params_from_numpy(host, "cpu")
    return jcfg, jp, tcfg, tp


def _tokens(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _vision(cfg, b, seed=0):
    """(B, num_patches, vision_dim) patch embeddings, or None for a
    config without ``xattn`` blocks."""
    if not cfg.vision_dim:
        return None
    rng = np.random.default_rng(100 + seed)
    return rng.normal(size=(b, cfg.num_patches, cfg.vision_dim)).astype(
        np.float32)


def _maybe(fn, arr):
    return None if arr is None else fn(arr)


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


BACKENDS = (("chunked", "chunked"), ("dense", "dense"), ("dense", "kernel"))


@pytest.mark.parametrize("name,jback,tback", [
    *((n, *b) for n in ("qwen3_0_6b", "phi3_mini_3_8b", "musicgen_large",
                        *MOE, "llama_3_2_vision_11b") for b in BACKENDS),
    # No block of these two reads the backend.
    ("recurrentgemma_9b", "chunked", "chunked"),
    ("xlstm_1_3b", "chunked", "chunked")])
def test_forward_matches_reference(name, jback, tback):
    """S = 96: one full 64-row tile of K6's plain version and a ragged
    one; JAX has no Pallas on the CPU, so the kernel backend is held to
    the dense reference.  The MoE SMOKE configs run the dropless
    ``moe_ref``; recurrentgemma's ``swa`` blocks (window 64) take the
    chunked path at every backend, and span more than their window."""
    jcfg, jp, tcfg, tp = _model(name)
    toks = _tokens(jcfg, 2, 96)
    vis = _vision(jcfg, 2)
    want = jt.forward(dataclasses.replace(jcfg, attn_backend=jback), jp,
                      jnp.asarray(toks), _maybe(jnp.asarray, vis))
    got = tt.forward(dataclasses.replace(tcfg, attn_backend=tback), tp,
                     torch.from_numpy(toks), _maybe(torch.from_numpy, vis))
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


def _assert_caches_close(tc, jc, where):
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for part in ("pattern", "tail"):
        jleaves = jax.tree_util.tree_flatten_with_path(jc[part])[0]
        tleaves = jax.tree.leaves(tc[part])
        assert len(tleaves) == len(jleaves)
        for (path, jleaf), tleaf in zip(jleaves, tleaves):
            np.testing.assert_allclose(
                tleaf.float().numpy(), np.asarray(jleaf, np.float32),
                atol=1e-5, rtol=1e-5,
                err_msg=f"{where}: {part}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("name,long,steps", [
    ("qwen3_0_6b", False, 20), ("phi3_mini_3_8b", False, 20),
    ("phi3_mini_3_8b", True, 20), ("musicgen_large", False, 20),
    ("llama4_scout_17b_a16e", False, 20), ("kimi_k2_1t_a32b", False, 20),
    ("kimi_k2_1t_a32b", True, 20), ("recurrentgemma_9b", False, 96),
    ("recurrentgemma_9b", True, 20), ("xlstm_1_3b", False, 20),
    ("xlstm_1_3b", True, 20), ("llama_3_2_vision_11b", False, 20),
    ("llama_3_2_vision_11b", True, 20)])
def test_decode_step_matches_reference(name, long, steps):
    """Per-step logits and every cache state after every step against
    JAX's decode_step; ``long`` with window 8 / ratio 4 over 20 steps
    crosses pushes and the window; recurrentgemma's 96 steps wrap its
    64-row ``swa`` ring; the VLM's cache is filled by
    ``precompute_vision_cache`` first."""
    over = dict(long_window=8, long_ratio=4) if long else {}
    jcfg, jp, tcfg, tp = _model(name, **over)
    B = 2
    toks = _tokens(jcfg, B, steps, seed=1)
    jc = jt.init_cache(jcfg, B, steps, long=long)
    tc = tt.init_cache(tcfg, B, steps, long=long, device="cpu")
    vis = _vision(jcfg, B, seed=1)
    if vis is not None:
        jc = jt.precompute_vision_cache(jcfg, jp, jc, jnp.asarray(vis))
        tc = tt.precompute_vision_cache(tcfg, tp, tc, torch.from_numpy(vis))
        _assert_caches_close(tc, jc, "vision cache")
    jstep = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, c, t,
                                                   long=long))
    for t in range(steps):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        tl, tc = tt.decode_step(tcfg, tp, tc, torch.from_numpy(
            toks[:, t:t + 1]), long=long)
        assert _rel(tl.numpy(), jl) < REL, t
        if name in NEW:
            _assert_caches_close(tc, jc, f"step {t}")
    _assert_caches_close(tc, jc, "last step")


@pytest.mark.parametrize("name,width,layers,dtype", [
    ("xlstm_1_3b", 256, 48, "float32"), ("xlstm_1_3b", 256, 48, "bfloat16"),
    ("recurrentgemma_9b", 128, 8, "bfloat16")],
    ids=["xlstm-48-fp32", "xlstm-48-bf16", "recurrentgemma-8-bf16"])
def test_deep_xlstm_amplifies_rounding_in_both_packages(name, width, layers,
                                                        dtype):
    """xlstm-1.3b's pattern at width 256 and its full 48 layers (the
    reference's parameters, 64 tokens at batch 1): rounding grows
    through the mLSTM normaliser in both packages alike, the reference's
    own decode departing from its own prefill by more than 1e-4 of max
    |logit| in fp32 (about 2e-6 at the SMOKE config's 2 layers), and by
    ~0.76 in bf16; recurrentgemma-9b's pattern at 8 layers in bf16 by
    ~2e-2.  The port's decode against its prefill, and its prefill
    against the reference's, stay within twice the reference's own
    departure: the noise floor that a full-width teacher-forced bar has
    to allow for (``chip_smoke.py`` phase 18 holds the card's decode to
    twice its own prefill's one-ulp change)."""
    over = dict(d_model=width, num_layers=layers, dtype=dtype)
    jcfg = dataclasses.replace(jget_arch(name), **over)
    tcfg = dataclasses.replace(get_arch(name), **over)
    jp = jinit(jax.random.PRNGKey(0), jt.arch_specs(jcfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    S = 64
    toks = _tokens(jcfg, 1, S, seed=7)
    jref = np.asarray(jax.jit(lambda p, t: jt.forward(jcfg, p, t))(
        jp, jnp.asarray(toks)))
    jc = jt.init_cache(jcfg, 1, S)
    jstep = jax.jit(lambda p, c, t: jt.decode_step(jcfg, p, c, t))
    jdec = []
    for t in range(S):
        lg, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]))
        jdec.append(np.asarray(lg))
    ref_err = _rel(np.concatenate(jdec, axis=1), jref)
    with torch.inference_mode():
        tref = tt.forward(tcfg, tp, torch.from_numpy(toks))
        tc = tt.init_cache(tcfg, 1, S, device="cpu")
        tdec = []
        for t in range(S):
            lg, tc = tt.decode_step(tcfg, tp, tc,
                                    torch.from_numpy(toks[:, t:t + 1]))
            tdec.append(lg)
    port_err = _rel(torch.cat(tdec, dim=1).float().numpy(),
                    tref.float().numpy())
    assert ref_err > 1e-4
    assert port_err <= 2 * ref_err
    assert _rel(tref.float().numpy(), jref) <= 2 * ref_err


@pytest.mark.parametrize("name", ["recurrentgemma_9b", "xlstm_1_3b"])
def test_long_decode_without_attention_blocks_equals_full(name):
    """Neither pattern has an ``attn``/``moe`` block (recurrentgemma's
    starts with ``rec`` and its ``swa`` blocks keep their ring either
    way; xlstm's with ``mlstm``), so ``long`` decode finds no stale-KV
    table to size and equals full decode bit for bit, cache and all."""
    cfg = dataclasses.replace(tget(name), long_window=8, long_ratio=4)
    params = init_params(tt.arch_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    B, S = 2, 24
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=6))
    cf = tt.init_cache(cfg, B, S, device="cpu")
    cl = tt.init_cache(cfg, B, S, long=True, device="cpu")
    for t in range(S):
        lf, cf = tt.decode_step(cfg, params, cf, toks[:, t:t + 1])
        ll, cl = tt.decode_step(cfg, params, cl, toks[:, t:t + 1],
                                long=True)
        assert torch.equal(ll, lf), t
    for a, b in zip(jax.tree.leaves(cl), jax.tree.leaves(cf)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", PORTED)
def test_decode_matches_forward(name):
    """Teacher forcing, as the reference's test_decode_matches_forward:
    the port's decode against the port's forward (kernel backend)."""
    cfg = dataclasses.replace(tget(name), attn_backend="kernel")
    params = init_params(tt.arch_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    for block in params["pattern"]:
        if "gate" in block:
            block["gate"].fill_(XATTN_GATE)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2))
    vis = _maybe(torch.from_numpy, _vision(cfg, B, seed=2))
    ref = tt.forward(cfg, params, toks, vis)
    cache = tt.init_cache(cfg, B, S, device="cpu")
    if vis is not None:
        cache = tt.precompute_vision_cache(cfg, params, cache, vis)
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
                                  "llama4_scout_17b_a16e", *NEW])
def test_params_and_cache_trees_match_reference(name):
    """``params_from_numpy`` keeps the stacked LM tree leaf for leaf; the
    port's own specs, init and caches have the reference's structure,
    shapes and dtypes."""
    jcfg, jp, tcfg, tp = _model(name)
    jleaves, jdef = jax.tree.flatten(jp)
    assert isinstance(tp["pattern"], list)
    assert len(tp["tail"]) == len(tcfg.tail)
    assert all(leaf.shape[0] == tcfg.repeats
               for leaf in jax.tree.leaves(tp["pattern"]))
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
            assert str(a.dtype).split(".")[-1] == str(b.dtype)


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


@pytest.mark.parametrize("name", ["kimi_k2_1t_a32b", "musicgen_large",
                                  *NEW])
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
    """Every architecture loads (the reference's ten, full and SMOKE, by
    id and by dashed alias) and ``all_archs`` is the reference's; what
    is not ported raises: the reference's ``"pallas"`` backend (the
    port's is ``"kernel"``).  One shard's experts without their mesh
    raise ValueError in ``moe_ep`` and ``moe_ref`` (expert parallelism
    itself: ``tests/test_torch_moe.py``)."""
    from repro.configs import ALIASES as JALIASES
    from repro.configs import ARCH_IDS as JARCH_IDS
    from repro.configs import all_archs as jall_archs
    from repro_torch.configs import ALIASES
    from repro_torch.models import moe as tmoe
    assert ARCH_IDS == JARCH_IDS and ALIASES == JALIASES
    assert sorted(PORTED) == sorted(ARCH_IDS)
    for name in ARCH_IDS:
        for get, jget_ in ((get_arch, jget_arch), (tget, jget)):
            want = dataclasses.asdict(jget_(name))
            got = dataclasses.asdict(get(name))
            assert got == want, name
    for alias, name in ALIASES.items():
        assert get_arch(alias) is get_arch(name)
    got, want = all_archs(), jall_archs()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            want[name])
    with pytest.raises(ValueError, match="backend"):
        _, _, tcfg, tp = _model("qwen3_0_6b")
        tt.forward(dataclasses.replace(tcfg, attn_backend="pallas"), tp,
                   torch.zeros((1, 4), dtype=torch.int32))
    _, _, tcfg, tp = _model("llama4_scout_17b_a16e")
    block = tp["pattern"][0]
    moe_params = {"router": block["router"][0], "w_gate":
                  block["w_gate_e"][0], "w_up": block["w_up_e"][0],
                  "w_down": block["w_down_e"][0]}
    half = dict(moe_params, **{k: moe_params[k][:tcfg.num_experts // 2]
                               for k in ("w_gate", "w_up", "w_down")})
    for fn in (tmoe.moe_ep, tmoe.moe_ref):
        with pytest.raises(ValueError, match="expert"):
            fn(torch.zeros((1, 4, tcfg.d_model)), half,
               tcfg.experts_per_token)


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


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-1.3b",
                                  "llama-3.2-vision-11b"])
@pytest.mark.parametrize("long", [False, True])
def test_serve_launcher_serves_the_new_families_on_the_cpu(arch, long,
                                                           capsys):
    """The hybrid, xLSTM and VLM SMOKE configs through the launcher, no
    new flag; the VLM's ``serve`` fills its vision cache first (a
    (B, num_patches, vision_dim) draw from seed 2)."""
    _serve_on_the_cpu(arch, long, capsys)


def test_serve_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "qwen3-0.6b", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_cache(tget("qwen3_0_6b"), 1, 8)
