"""Device and idle time charged to the program's spans
(``bench/phases.py``), on a trace built by hand, and the six readers
that read them; then, marked ``cuda``, one traced epoch on the card.

The hand-built trace: one epoch's spans on the caller's thread, launches
inside them (the one in ``gnn.backward`` stands for autograd's device
thread, which launches while the caller waits in the span), one launch
after the epoch, device ops after their launches (two overlapping), and
the idle gaps between them.  Every number below is worked out by hand.
"""
import math

import pytest
import torch

from bench import harness, phases, profiling, spec

SPANS = [("digest.epoch", 10, 900), ("digest.gather", 15, 100),
         ("digest.subgraph", 110, 600), ("gnn.forward", 115, 300),
         ("gnn.backward", 300, 590), ("digest.update", 610, 700),
         ("store.push", 710, 880)]
CALLS = [("cudaLaunchKernel", 30, 35), ("aten::index", 25, 60),
         ("cudaLaunchKernel", 130, 134), ("cudaLaunchKernel", 140, 144),
         ("cudaLaunchKernel", 320, 324),        # autograd's thread
         ("cudaLaunchKernel", 620, 624), ("cudaMemcpyAsync", 720, 740),
         ("cudaLaunchKernel", 950, 952), ("cudaStreamSynchronize", 960, 995)]
OPS = [("gather_kernel", 40, 90), ("spmm_kernel", 150, 200),
       ("halo_list_kernel", 190, 260), ("bwd_table_kernel", 330, 500),
       ("adam_kernel", 630, 650), ("Memcpy DtoD", 730, 800),
       ("fill_kernel", 955, 990)]
BUSY = {"digest.gather": 50, "gnn.forward": 50 + 60,
        "gnn.backward": 170, "digest.update": 20, "store.push": 70,
        "outside": 35}
IDLE = {"digest.gather": 40, "gnn.forward": 60 + 70, "gnn.backward": 130,
        "digest.update": 80, "store.push": 155, "outside": 10}
EPOCHS = 2
NEW = ("gather_ms.train", "forward_ms.train", "backward_ms.train",
       "update_ms.train", "store_ms.train")


def _trace(spans=SPANS, calls=CALLS) -> dict:
    tr = {"span": (0, 1000), "device": list(OPS),
          "host": sorted(spans + calls, key=lambda h: h[1])}
    tr["busy_ns"] = profiling.busy_ns(tr)
    tr["window_ns"] = profiling.window_ns(tr)
    return tr


def _ctx(tr) -> dict:
    cell = spec.resolve("gcn-products.n10")
    return {"config": cell["config"], "traffic": cell["traffic"],
            "stats": {"parts": [{"nodes": 100, "in_edges": 1000,
                                 "cross_edges": 200, "halo": 50}],
                      "boundary": 50},
            "trace": tr, "profiled_epochs": EPOCHS,
            "dispatch_s": [0.03, 0.04], "untraced_epoch_s": 2e-6}


def test_busy_and_idle_are_charged_to_the_right_spans():
    tr = _trace()
    assert tr["busy_ns"] == 455
    busy = phases.busy_by_span(tr)
    assert {k: v[0] for k, v in busy.items()} == BUSY
    assert {k: v[1] for k, v in busy.items()} == {
        "digest.gather": 1, "gnn.forward": 2, "gnn.backward": 1,
        "digest.update": 1, "store.push": 1, "outside": 1}
    assert sum(v[0] for v in busy.values()) == tr["busy_ns"]
    idle = phases.idle_by_span(tr)
    assert idle == IDLE
    assert sum(idle.values()) == tr["window_ns"] - tr["busy_ns"]


def test_an_op_that_shows_a_start_before_its_launch_keeps_it():
    # The adam kernel starts at 630: its launch recorded at 632 on the
    # host's clock is still its launch, and the next op keeps its own.
    calls = [c if c[1] != 620 else ("cudaLaunchKernel", 632, 636)
             for c in CALLS]
    busy = phases.busy_by_span(_trace(calls=calls))
    assert {k: v[0] for k, v in busy.items()} == BUSY
    assert phases.pair(_trace(calls=calls))[4:6] == [632, 720]


def test_host_time_is_each_spans_own():
    host = phases.host_by_span(_trace())
    assert host["digest.epoch"] == [890 - 85 - 490 - 90 - 170, 1]
    assert host["digest.subgraph"] == [490 - 185 - 290, 1]
    assert host["gnn.forward"] == [185, 1]
    assert host["outside"] == [1000 - 890, 0]
    rows = phases.table(_trace(), EPOCHS)
    total = rows[-1]
    assert total[0] == "total"
    assert math.isclose(total[1], 455 / 1e6 / EPOCHS)
    assert math.isclose(total[2], 545 / 1e6 / EPOCHS)
    assert math.isclose(total[3], 1000 / 1e6 / EPOCHS)
    assert math.isclose(total[4], len(OPS) / EPOCHS)


def test_innermost_takes_the_deepest_open_span():
    sp = phases.spans(_trace())
    assert phases.innermost(sp, [5, 15, 99, 100, 115, 300, 899, 900]) == [
        "outside", "digest.gather", "digest.gather", "digest.epoch",
        "gnn.forward", "gnn.backward", "digest.epoch", "outside"]


def test_the_readers_read_the_spans():
    ctx = _ctx(_trace())
    want = {"gather_ms.train": 50, "forward_ms.train": 110,
            "backward_ms.train": 170, "update_ms.train": 20,
            "store_ms.train": 70}
    for name in NEW:
        got = spec.metric_module(name).read(ctx)
        assert math.isclose(got, want[name] / 1e6 / EPOCHS), name
    # The probe's span, here holding the push's copy, reads in store_ms.
    probe = [s if s[0] != "store.push" else ("store.probe", 705, 725)
             for s in SPANS] + [("store.push", 725, 880)]
    tr = _trace(spans=probe)
    assert phases.busy_by_span(tr)["store.probe"] == [70, 1]
    got = spec.metric_module("store_ms.train").read(_ctx(tr))
    assert math.isclose(got, 70 / 1e6 / EPOCHS)
    # A program without the spans (or no trace): nothing to read.
    for name in NEW:
        mod = spec.metric_module(name)
        assert mod.read(_ctx(_trace(spans=[]))) is None
        assert mod.read({**_ctx(None), "trace": None}) is None


def test_ops_and_launches_that_do_not_pair_charge_nothing():
    # A lost launch record, or one more launch than ops: the k-th launch
    # no longer starts the k-th op, so no span is charged.
    for calls in (CALLS[:2] + CALLS[3:], CALLS + [("cudaMemsetAsync", 996,
                                                   998)]):
        tr = _trace(calls=calls)
        assert phases.pair(tr) is None
        assert phases.busy_by_span(tr) is None
        for name in NEW:
            assert spec.metric_module(name).read(_ctx(tr)) is None, name
    assert phases.pair(_trace()) == [30, 130, 140, 320, 620, 720, 950]


def test_store_mb_reads_the_programs_counters():
    from repro_torch import trace
    mod = spec.metric_module("store_mb.train")
    trace.reset_counters()
    assert mod.read(_ctx(_trace())) is None
    trace.COUNTERS.update({"digest.epochs": 4, "store.pull_bytes": 10 ** 6,
                           "store.push_bytes": 10 ** 6})
    try:
        assert mod.read(_ctx(_trace())) == 0.5
        assert mod.read({**_ctx(_trace()), "trace": None}) is None
    finally:
        trace.reset_counters()


@pytest.mark.parametrize("name", ["dispatch_ms.train",
                                  "device_idle_pct.train", "mfu.train",
                                  "spmm_roofline.train",
                                  "halo_spmm_roofline.train"])
def test_the_accepted_readers_read_the_same(name):
    mod = spec.metric_module(name)
    before = mod.read(_ctx(_trace(spans=[])))
    assert before is not None
    tr = _trace()
    assert mod.read(_ctx(tr)) == before
    for new in NEW:
        spec.metric_module(new).read(_ctx(tr))
    assert "by_span" in tr
    assert mod.read(_ctx(tr)) == before


@pytest.mark.cuda
def test_every_op_of_a_traced_epoch_is_charged_once_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile, record_function
    cell = spec.resolve("gcn-products.n10")
    cell["config"] = {**cell["config"], "num_nodes": 12000}
    prog, _, _, _ = harness.warm_up(cell, 2 ** 31 + 5, "cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(harness.SPAN):
            prog.epoch()
            torch.cuda.synchronize()
    tr = profiling.summarize(prof, harness.SPAN)
    tr["busy_ns"] = profiling.busy_ns(tr)
    truth = phases.correlated(prof, tr)
    assert tr["device"] and all(t is not None for t in truth)
    assert phases.pair(tr) == truth
    busy = phases.busy_by_span(tr)
    assert sum(v[1] for v in busy.values()) == len(tr["device"])
    assert sum(v[0] for v in busy.values()) == tr["busy_ns"]
    assert {"digest.gather", "gnn.forward", "gnn.backward",
            "digest.update"} <= set(busy)
