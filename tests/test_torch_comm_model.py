"""The analytic communication model in the port against the reference.

Both packages partition the same flickr-sim graph (scale 0.2, 4 parts;
byte-identical partitions) and evaluate the model with the same numbers:
the port's ``CommConstants`` built from the field values of the
reference's ``CommConstants()``.  Tolerance: none — every count, byte and
time equals the reference's exactly (``==``), in every mode, with and
without a ``halo_precision``.  Then the reference's own ordering and
amortisation properties (``tests/test_comm_model.py``) on the port, with
its default constants, which are an H100's.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import comm_model as jcm
from repro.core import halo_exchange as jhx
from repro.graph import build_partitions as jbuild
from repro.graph import make_dataset as jmake
from repro.models.gnn import GNNConfig, gnn_specs
from repro.nn import param_count
from repro_torch.core import comm_model as tcm
from repro_torch.core import halo_exchange as thx
from repro_torch.graph import build_partitions as tbuild
from repro_torch.graph import make_dataset as tmake

MODES = ("partition", "digest", "propagation")


@functools.lru_cache(maxsize=None)
def _setup():
    jg, tg = jmake("flickr-sim", scale=0.2), tmake("flickr-sim", scale=0.2)
    cfg = GNNConfig(num_layers=3, in_dim=jg.features.shape[1],
                    hidden_dim=64, num_classes=8)
    return jg, jbuild(jg, 4), tg, tbuild(tg, 4), param_count(gnn_specs(cfg))


def _ref_consts():
    """The port's constants set to the reference's default values."""
    return tcm.CommConstants(**dataclasses.asdict(jcm.CommConstants()))


def test_default_constants_are_the_h100s():
    c = tcm.CommConstants()
    assert (c.link_bandwidth, c.flops, c.bytes_per_scalar) == (
        450e9, 989.4e12, 4)
    assert [f.name for f in dataclasses.fields(c)] == [
        f.name for f in dataclasses.fields(jcm.CommConstants)]


@pytest.mark.parametrize("k_max", [1, 2, 3])
def test_khop_halo_sizes_equal_reference(k_max):
    jg, jsp, tg, tsp, _ = _setup()
    got = tcm.khop_halo_sizes(tg, tsp, k_max)
    want = jcm.khop_halo_sizes(jg, jsp, k_max)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("storage", [None, "fp32", "bf16", "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_epoch_comm_bytes_equal_reference(mode, storage):
    jg, jsp, tg, tsp, pc = _setup()
    jp = None if storage is None else jhx.HaloPrecision(storage)
    tp = None if storage is None else thx.HaloPrecision(storage)
    for interval in (1, 10):
        for layers in (1, 3):
            want = jcm.epoch_comm_bytes(mode, jsp, jg, pc, 64, layers,
                                        interval, halo_precision=jp)
            got = tcm.epoch_comm_bytes(mode, tsp, tg, pc, 64, layers,
                                       interval, _ref_consts(),
                                       halo_precision=tp)
            assert got == want, (mode, storage, interval, layers)


@pytest.mark.parametrize("mode", MODES)
def test_epoch_time_model_equals_reference(mode):
    jg, jsp, tg, tsp, pc = _setup()
    d = jg.features.shape[1]
    want = jcm.epoch_time_model(mode, jsp, jg, pc, 64, 3, d, 10)
    got = tcm.epoch_time_model(mode, tsp, tg, pc, 64, 3, d, 10,
                               _ref_consts())
    assert got == want
    with pytest.raises(ValueError):
        tcm.epoch_comm_bytes("x", tsp, tg, pc, 64, 3)


def test_mode_ordering():
    _, _, g, sp, pc = _setup()
    b = {m: tcm.epoch_comm_bytes(m, sp, g, pc, 64, 3, 10) for m in MODES}
    assert b["partition"] < b["digest"] < b["propagation"]


def test_interval_amortization():
    _, _, g, sp, pc = _setup()
    b1 = tcm.epoch_comm_bytes("digest", sp, g, pc, 64, 3, 1)
    b10 = tcm.epoch_comm_bytes("digest", sp, g, pc, 64, 3, 10)
    assert b10 < b1


def test_khop_halo_monotone():
    _, _, g, sp, _ = _setup()
    kh = tcm.khop_halo_sizes(g, sp, 3)
    assert (np.diff(kh, axis=1) >= 0).all()     # halos grow with depth


def test_time_model_positive():
    _, _, g, sp, pc = _setup()
    t = tcm.epoch_time_model("digest", sp, g, pc, 64, 3, g.features.shape[1])
    assert t["t_epoch"] > 0 and t["bytes"] > 0
    # Communication time scales inversely with the link bandwidth.
    slow = tcm.CommConstants(link_bandwidth=45e9)
    t2 = tcm.epoch_time_model("digest", sp, g, pc, 64, 3,
                              g.features.shape[1], consts=slow)
    assert t2["t_comm"] == pytest.approx(10 * t["t_comm"])
