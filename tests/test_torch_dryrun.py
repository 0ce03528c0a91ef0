"""The port's dry run (``repro_torch.launch.{specs,dryrun,dryrun_gnn,
census_check}``) against the reference and against the port's own real
runs.

* Specs: ``input_specs``, ``serve_state_specs`` and
  ``train_state_specs(cfg, 2, True)`` of the ten architectures at the
  four shapes give the reference's tree, shapes, axes and dtypes (tokens
  int32 in both); ``abstract_gnn_case`` the key tree, ranks and dtypes
  of ``prepare_graph_data`` + ``shard_data`` on a small graph, and the
  reference's shapes on the keys both packages share (a JAX subprocess:
  the reference module forces 512 host devices at import).
* Dry against real, port against port: qwen3-0.6b SMOKE's train step,
  prefill and decode over ("data", "model") = 2 x 2 and the collective
  GCN epoch over ("pod", "data") = 2 x 2, dry in a stand-in group of 4
  here (ranks 0 and 3) against four real gloo ranks
  (``tests/test_torch_mesh.py::dry_census_job``): the census equal op
  for op, calls and bytes.  At world 1 the dry FLOPs equal
  ``FlopCounterMode`` over the real CPU run (the kernels' plain versions
  left out) plus the kernels' dry counts.
* Each kernel wrapper's meta branch: the plain version's output shapes
  and dtypes, a count in ``_build.DRY`` and none in ``LAUNCHES``, and no
  plain arithmetic on a meta tensor.  The expert-parallel MoE forward on
  meta tensors (``nn.count_ids`` in place of ``torch.bincount``).
* ``census_check`` gives the reference's verdicts under the op-name map;
  the production mesh and the stand-in group; the full-width cases
  (qwen3-0.6b's four shapes at 16 x 16 and ``train_4k`` at 2 x 16 x 16,
  the GNN census's three CI records at 2 x 16 x 16); the examples parse
  their arguments.
"""
import importlib
import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dry_cases as cases  # noqa: E402
from test_torch_mesh import spawn  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch import census_check as jcensus  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_arch, get_smoke_arch  # noqa
from repro_torch.core import collectives  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import census_check, dryrun, dryrun_gnn  # noqa
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.mesh import (dry_group, make_mesh,  # noqa: E402
                                     make_production_mesh)
from repro_torch.models.transformer import arch_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Specs against the reference
# ---------------------------------------------------------------------------

def _flat(tree, path=""):
    """``[(path, leaf)]`` in the reference's tree order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                        f"{path}/{k}")]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, f"{path}/{i}")]
    return [(path, tree)]


def _dtype(d) -> str:
    return np.dtype(d).name if not isinstance(d, torch.dtype) \
        else str(d).split(".")[-1]


def _same_specs(mine, ref, axes=True):
    a, b = _flat(mine), _flat(ref)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert tuple(x.shape) == tuple(y.shape), path
        assert _dtype(x.dtype) == _dtype(y.dtype), path
        if axes:
            assert tuple(x.axes) == tuple(y.axes), path


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jget_arch(arch)
    for shape in specs.SHAPES:
        assert specs.SHAPES[shape] == jspecs.SHAPES[shape]
        mine = specs.input_specs(cfg, shape)
        _same_specs(mine, jspecs.input_specs(jcfg, shape), axes=False)
        assert {k: v.axes for k, v in mine.items()} == \
            jspecs.batch_logical_axes(jcfg, shape)
        _same_specs(specs.serve_state_specs(cfg, shape),
                    jspecs.serve_state_specs(jcfg, shape))
    _same_specs(specs.train_state_specs(cfg, 2, True),
                jspecs.train_state_specs(jcfg, 2, True))
    _same_specs(specs.train_state_specs(cfg), jspecs.train_state_specs(jcfg))


_REF_GNN = """
import json, sys
from repro.launch.dryrun_gnn import abstract_gnn_case
out = []
for a in json.loads(sys.argv[1]):
    data = abstract_gnn_case(*a)[0]
    out.append({k: ({kk: list(vv.shape) for kk, vv in v.items()}
                    if isinstance(v, dict) else list(v.shape))
                for k, v in data.items()})
print(json.dumps(out))
"""


def test_abstract_gnn_case_has_the_real_keys_and_the_reference_shapes():
    g_args = [[4096, 16, 32, 64, 8, 16, 8, 1.0],
              [1_048_576, 512, 128, 256, 64, 16, 8, 1.0]]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REF_GNN,
                          json.dumps(g_args)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for a, ref in zip(g_args, json.loads(res.stdout)):
        data = dryrun_gnn.abstract_gnn_case(*a)[0]
        for k, v in ref.items():
            if isinstance(v, dict):
                for kk, shape in v.items():
                    assert list(data[k][kk].shape) == shape, (k, kk)
            else:
                assert list(data[k].shape) == v, k
    # The key tree, ranks and dtypes of a real partitioned graph's rank
    # view, on the port's keys.
    _, _, _, real = cases.gnn_setup()
    real = {k: v for k, v in real.items() if not k.startswith("_")}
    abstract = dryrun_gnn.abstract_gnn_case(256, cases.GNN_PARTS, 8, 16,
                                            4, 16, 8, 1.0)[0]
    with dry_group(4, 3):
        mesh = make_mesh(4)
        from repro_torch.core.digest import shard_data
        mine, want = shard_data(abstract, mesh), shard_data(real, mesh)
        del mesh
    a, b = _flat(mine), _flat(want)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dim() == y.dim() and x.dtype == y.dtype, path
        assert x.is_meta, path


# ---------------------------------------------------------------------------
# Dry against real, port against port
# ---------------------------------------------------------------------------

def _dry_census(rank: int) -> dict:
    out = {}
    with dry_group(4, rank):
        mesh = make_mesh(2, 1, "cpu", 2)
        for kind, shape in cases.LM_SHAPES.items():
            rec = dryrun.lm_case(cases.lm_cfg(), shape, mesh)
            out[kind] = rec
        run, args, params = cases.gnn_run(make_mesh(2, 2), meta=True)
        out["gnn"] = dryrun.measure(run, args, params)
        del mesh
    return out


def test_dry_census_equals_a_real_gloo_run():
    real = spawn("dry_census_job", 4)
    for rank in (0, 3):
        dry = _dry_census(rank)
        for case, (counts, nbytes, spans) in real[rank].items():
            rec = dry[case]
            assert rec["collective_counts"] == counts, (rank, case)
            assert rec["collective_per_op"] == nbytes, (rank, case)
            assert {k: rec[f"{k}_bytes"] for k in spans} == spans, \
                (rank, case)
            assert rec["collective_bytes"] == sum(nbytes.values())
        assert dry["gnn"]["collective_counts"].get("all_gather", 0) == 0
        assert dry["gnn"]["collective_counts"]["send"] >= 1


@pytest.fixture
def plain_uncounted(monkeypatch):
    """Every kernel's plain version run with the dispatch modes (a
    ``FlopCounterMode``) suspended: the real run's counted FLOPs are then
    the program's own, the kernels' being the dry ledger's."""
    from torch.utils._python_dispatch import _disable_current_modes

    fa, ge, hp, sp = _kernel_modules()

    def quiet(fn):
        def run(*a, **k):
            with _disable_current_modes():
                return fn(*a, **k)
        return run

    for mod, names in ((fa, ["flash_attention_plain"]),
                       (ge, ["gat_edge_partial_plain"]),
                       (hp, ["halo_spmm_plain", "halo_spmm_stream_plain",
                             "halo_spmm_skip_plain"]),
                       (sp, ["spmm_plain", "spmm_bwd_table_plain",
                             "spmm_bwd_wts_plain"])):
        for name in names:
            monkeypatch.setattr(mod, name, quiet(getattr(mod, name)))


@pytest.mark.parametrize("case", ["train", "prefill", "decode", "gnn"])
def test_dry_flops_at_world_one_equal_the_real_run(case, plain_uncounted):
    from torch.utils.flop_counter import FlopCounterMode
    if case == "gnn":
        run, _, _ = cases.gnn_run(None, meta=False, collective=False)
        dry_run, args, params = cases.gnn_run(None, meta=True,
                                              collective=False)
        dry = dryrun.measure(dry_run, args, params)
    else:
        run = cases.lm_real(case, None)
        dry = dryrun.lm_case(cases.lm_cfg(), cases.LM_SHAPES[case], None)
    with FlopCounterMode(display=False) as fc:
        run()
    kernels = sum(r["flops"] for r in dry["kernels"].values())
    assert dry["flops"] == fc.get_total_flops() + kernels
    assert dry["flops"] > 0 and dry["device_ops"] > 0
    if case in ("prefill", "gnn"):
        assert kernels > 0
    assert dry["collective_counts"] == {}


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------

def _kernel_modules() -> tuple:
    """The wrappers' modules (the package names shadow some of them)."""
    return tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                 for m in ("flash_attention.flash_attention",
                           "gat_edge.gat_edge", "spmm.halo_pull",
                           "spmm.spmm"))


def _kernel_cases():
    from repro_torch.graph.transpose import ell_transpose
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.gat_edge import gat_edge_partial_cuda
    _, _, hp, sp = _kernel_modules()
    rng = np.random.default_rng(0)
    rows, deg, n_tab, feat = 300, 6, 97, 24
    nbr = torch.from_numpy(rng.integers(0, n_tab, (rows, deg))
                           .astype(np.int32))
    wts = torch.from_numpy(rng.standard_normal((rows, deg))
                           .astype(np.float32))
    tab = torch.randn((n_tab, feat))
    q8 = torch.randint(-127, 128, (n_tab, feat), dtype=torch.int8)
    sc = torch.rand((n_tab, 1))
    pos = torch.from_numpy(ell_transpose(nbr.numpy(), n_tab))
    g = torch.randn((rows, feat))
    n_blocks = -(-rows // 128)
    n_chunks = -(-n_tab // 32)
    wl_ids = torch.arange(n_chunks, dtype=torch.int32).repeat(n_blocks, 1)
    wl_cnt = torch.full((n_blocks,), n_chunks, dtype=torch.int32)
    valid = torch.from_numpy(rng.random((rows, deg)) < 0.8)
    q = torch.randn((2, 4, 40, 32)).to(torch.bfloat16)
    kv = torch.randn((2, 2, 40, 32)).to(torch.bfloat16)
    q3, k3 = torch.randn((8, 33, 16)), torch.randn((4, 33, 16))
    return [
        ("spmm", sp.spmm_cuda, (nbr, wts, tab)),
        ("spmm_bwd_table", sp.spmm_bwd_table, (pos, wts, g)),
        ("spmm_bwd_wts", sp.spmm_bwd_wts, (nbr, g, tab)),
        ("halo_spmm", hp.halo_spmm_cuda, (nbr, wts, q8, sc)),
        ("halo_spmm", hp.halo_spmm_cuda,
         (nbr, wts, tab, None, tab.clone(), None, 0.5)),
        ("halo_spmm_stream", hp.halo_spmm_stream_cuda,
         (nbr, wts, q8, sc, None, None, 1.0, 32)),
        ("halo_spmm_stream", hp.halo_spmm_stream_walk_cuda,
         (nbr, wts, q8, sc, None, None, 1.0, 32)),
        ("halo_spmm_skip", hp.halo_spmm_skip_cuda,
         (nbr, wts, q8, sc, wl_ids, wl_cnt, None, None, 1.0, 32, True)),
        ("gat_edge_partial", gat_edge_partial_cuda,
         (nbr, valid, torch.randn(rows), torch.randn(n_tab), tab)),
        ("flash_attention", flash_attention_cuda, (q, kv, kv.clone())),
        ("flash_attention", flash_attention_cuda, (q3, k3, k3.clone())),
    ]


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in outs]


def test_each_meta_branch_counts_its_kernel_and_launches_nothing(
        monkeypatch):
    fa, ge, hp, sp = _kernel_modules()
    # No plain version may see a meta tensor.
    for mod in (fa, ge, hp, sp):
        for name in [n for n in dir(mod) if n.endswith("_plain")]:
            fn = getattr(mod, name)

            def guard(*a, _fn=fn, _name=name, **k):
                assert not any(isinstance(t, torch.Tensor) and t.is_meta
                               for t in list(a) + list(k.values())), _name
                return _fn(*a, **k)
            monkeypatch.setattr(mod, name, guard)
    _build.reset_launches()
    for name, fn, args in _kernel_cases():
        want = _shapes(fn(*args))
        _build.reset_dry()
        meta = [cases.to_meta(a) if isinstance(a, torch.Tensor) else a
                for a in args]
        got = fn(*meta)
        assert _shapes(got) == want, name
        assert all(t.is_meta for t in (got if isinstance(got, tuple)
                                       else (got,)))
        rec = _build.DRY[name]
        assert rec["calls"] == 1 and rec["flops"] > 0 and rec["bytes"] > 0
    assert sum(_build.LAUNCHES.values()) == 0


def test_expert_parallel_moe_forward_runs_on_meta_tensors():
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.transformer import aux_moe_stats
    from repro_torch.nn import abstract_params, count_ids
    ids = torch.randint(0, 9, (300,))
    assert torch.equal(count_ids(ids, 9), torch.bincount(ids, minlength=9))
    assert count_ids(ids.to("meta"), 9).shape == (9,)
    cfg = get_smoke_arch("llama4-scout-17b-a16e")
    params = abstract_params(arch_specs(cfg))
    p = params["pattern"][0]
    block = {"router": p["router"][0], "w_gate": p["w_gate_e"][0],
             "w_up": p["w_up_e"][0], "w_down": p["w_down_e"][0]}
    x = torch.empty((2, 8, cfg.d_model), device="meta")
    y = moe_ffn(x, block, cfg.experts_per_token, impl="ep",
                capacity_factor=cfg.moe_capacity_factor)
    assert y.shape == x.shape and y.is_meta
    tokens = torch.empty((2, 8), dtype=torch.int32, device="meta")
    stats = aux_moe_stats(cfg, params, tokens)
    assert stats[0][0].shape == (cfg.num_experts,)


# ---------------------------------------------------------------------------
# census_check, the mesh, the stand-in group
# ---------------------------------------------------------------------------

_NAMES = {"all-gather": "all_gather", "all-to-all": "all_to_all",
          "collective-permute": "send"}


def _record(**counts):
    return {"mesh": "2x16x16", "precision": "fp32", "parts_per_device": 1,
            "collective_counts": counts}


def _port(rec):
    rec = dict(rec)
    if "collective_counts" in rec:
        rec["collective_counts"] = {_NAMES[k]: v for k, v in
                                    rec["collective_counts"].items()}
    return rec


@pytest.mark.parametrize("records,expect", [
    ([_record(**{"all-to-all": 1, "collective-permute": 1})] * 2, 2),
    ([_record(**{"all-to-all": 2, "collective-permute": 2})] * 3, 3),
    ([_record(**{"all-to-all": 1, "collective-permute": 1,
                 "all-gather": 0})] * 2, 2),
    ([_record(**{"all-to-all": 1, "collective-permute": 1,
                 "all-gather": 3})] * 2, 2),
    ([_record(**{"collective-permute": 1})] * 2, 2),
    ([_record(**{"all-to-all": 1})] * 2, 2),
    ([_record(**{"all-to-all": 1, "collective-permute": 1})], 2),
    ([{"mesh": "2x16x16"}] * 2, 2),
    ([], 2),
    ([_record(**{"all-to-all": 1, "collective-permute": 1})], 0),
])
def test_census_check_gives_the_reference_verdicts(records, expect):
    want = jcensus.check_census(records, expect)
    got = census_check.check_census([_port(r) for r in records], expect)
    assert bool(got) == bool(want) and len(got) == len(want)


def test_census_check_main_exit_codes(tmp_path):
    good = tmp_path / "census-ok.jsonl"
    bad = tmp_path / "census-bad.jsonl"
    ok = _port(_record(**{"all-to-all": 1, "collective-permute": 1}))
    good.write_text("\n".join(json.dumps(ok) for _ in range(3)) + "\n")
    worse = dict(ok, collective_counts=dict(ok["collective_counts"],
                                            all_gather=1))
    bad.write_text("\n".join(json.dumps(r) for r in (ok, worse, ok)))
    assert census_check.main([str(good), "--records", "3"]) == 0
    assert census_check.main([str(bad), "--records", "3"]) == 1


def test_production_mesh_and_the_stand_in_group():
    with dry_group(256, 5):
        mesh = make_production_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (16, 16)
        with pytest.raises(ValueError, match="contradicts"):
            make_production_mesh(multi_pod=True, pods=1)
        with pytest.raises(ValueError, match="contradicts"):
            make_production_mesh(pods=0)
        with pytest.raises(ValueError, match="world size of 512, not 256"):
            make_production_mesh(multi_pod=True)
        with pytest.raises(RuntimeError, match="initialised"):
            with dry_group(4):
                pass
        del mesh
    with dry_group(512, 511):
        mesh = make_production_mesh(multi_pod=True)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
        assert tuple(mesh.shape) == (2, 16, 16)
        assert collectives.POD_RANKS == 256
        assert list(mesh.get_coordinate()) == [1, 15, 15]
        del mesh
    assert collectives.POD_RANKS == 0
    with dry_group(4):
        with pytest.raises(ValueError, match="world size of 256, not 4"):
            make_production_mesh()


def test_train_launcher_builds_the_production_mesh_or_names_the_world(
        monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch import train
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for key, value in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                       "RANK": "0", "WORLD_SIZE": "1",
                       "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(key, value)
    with pytest.raises(ValueError, match="world size of 256, not 1"):
        train.main(["--device", "cpu", "--smoke", "--arch", "qwen3-0.6b",
                    "--production-mesh", "--dist-backend", "gloo"])
    assert not dist.is_initialized()


def test_collective_census_splits_bytes_by_span():
    with dry_group(16, 9):
        t = torch.empty((3, 5), device="meta")
        collectives.reset_collectives()
        collectives.all_gather(t)
        collectives.all_reduce(t)
        collectives.exchange([(t, 10)], [(t, 8)])
        collectives.exchange([(t, 1)], [(t, 0)])
        assert collectives.COLLECTIVES == {"all_gather": 1, "all_reduce": 1,
                                           "send": 2, "recv": 2}
        assert collectives.COLLECTIVE_BYTES == {
            "all_gather": 16 * 60, "all_reduce": 60, "recv": 120}
        # 9 and 8 share a host of 8 cards; 9 and 0, and the world, do not.
        assert collectives.COLLECTIVE_SPANS == {
            "intra_host": 60, "inter_host": 16 * 60 + 60 + 60}
        collectives.set_pod_ranks(8)
        collectives.reset_collectives()
        collectives.all_reduce(t)
        assert collectives.COLLECTIVE_SPANS["inter_pod"] == 60


# ---------------------------------------------------------------------------
# Full width
# ---------------------------------------------------------------------------

_FIELDS = ("arch", "shape", "mesh", "chips", "rank", "cost_basis",
           "collective_per_op", "collective_counts", "collective_bytes",
           "inter_pod_bytes", "inter_host_bytes", "compute_term_s",
           "memory_term_s", "collective_term_s", "flops_by_dtype",
           "hbm_bytes", "device_ops", "kernels", "mem_argument_bytes",
           "mem_peak_bytes", "tf32", "t_dry_s")


@pytest.mark.parametrize("shape,multi", [
    ("train_4k", False), ("prefill_32k", False), ("decode_32k", False),
    ("long_500k", False), ("train_4k", True)])
def test_qwen3_full_width_records(shape, multi):
    rec = dryrun.dryrun_case("qwen3-0.6b", shape, multi)
    for field in _FIELDS:
        assert field in rec, field
    assert rec["chips"] == (512 if multi else 256)
    assert rec["cost_basis"] == "eager"
    cfg = get_arch("qwen3-0.6b")
    sizes = ({"pod": 2} if multi else {}) | {"data": 16, "model": 16}
    rules = sharding.TRAIN_RULES if shape == "train_4k" else None
    assert rec["mem_param_bytes"] == sharding.local_bytes(
        arch_specs(cfg), sizes, rules)
    assert rec["mem_peak_bytes"] >= rec["mem_argument_bytes"] > 0
    for term in ("compute_term_s", "memory_term_s", "collective_term_s"):
        assert rec[term] > 0, term
    if shape == "prefill_32k":
        assert rec["kernels"]["flash_attention"]["calls"] == cfg.num_layers
    if multi:
        assert rec["inter_pod_bytes"] > 0


def test_gnn_census_records_at_2x16x16_pass_the_check(tmp_path):
    out = tmp_path / "census-multipod.jsonl"
    flags = [[], ["--precision", "int8", "--parts-per-device", "2"],
             ["--predictor", "ema"]]
    for extra in flags:
        assert dryrun_gnn.main(["--multi-pod", "--pull", "collective",
                                "--out", str(out)] + extra) == 0
    records = [json.loads(line) for line in out.read_text().splitlines()]
    assert census_check.check_census(records, 3) == []
    for rec in records:
        assert rec["mesh"] == "2x16x16" and rec["chips"] == 512
        assert rec["collective_counts"].get("all_gather", 0) == 0
        assert rec["collective_inter_pod_bytes"] > 0
        assert rec["kernels"]["spmm"]["calls"] > 0


# ---------------------------------------------------------------------------
# Examples
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(
    p.stem for p in (ROOT / "examples").glob("torch_*.py")))
def test_examples_parse_their_arguments(name, capsys):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(SystemExit) as exit_:
        mod.main(["--help"])
    assert exit_.value.code == 0
    assert "--device" in capsys.readouterr().out
