"""The port's data preparation and serving plan equal the reference's,
array for array (its graph modules are copies of the reference's)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro.core import serving as jserving
from repro.core.digest import prepare_graph_data as j_prepare
from repro.graph import make_dataset as j_make_dataset
from repro_torch.core import serving as tserving
from repro_torch.core.digest import prepare_graph_data as t_prepare
from repro_torch.graph import make_dataset as t_make_dataset
from repro_torch.graph.transpose import ell_transpose


# Keys the port adds beside the reference's: the transposed in- and
# out-ELLs its SpMM backward gathers through (held by
# test_prepare_graph_data_equal).
PORT_ONLY = {"in_pos", "out_pos"}


def _pairs(jtree, ttree, path=""):
    """(path, reference array, port tensor) for every traced leaf."""
    if isinstance(jtree, dict):
        assert sorted(jtree) == sorted(k for k in ttree
                                       if k not in PORT_ONLY), path
        for k in jtree:
            if not k.startswith("_"):
                yield from _pairs(jtree[k], ttree[k], f"{path}/{k}")
    else:
        yield path, np.asarray(jtree), ttree


@pytest.fixture(scope="module")
def both():
    jg = j_make_dataset("flickr-sim", scale=0.1, seed=2)
    tg = t_make_dataset("flickr-sim", scale=0.1, seed=2)
    return (j_prepare(jg, 4, seed=0), t_prepare(tg, 4, seed=0, device="cpu"),
            jg, tg)


def test_graph_build_equal(both):
    _, _, jg, tg = both
    for f in dataclasses.fields(jg):
        a, b = getattr(jg, f.name), getattr(tg, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name


def test_prepare_graph_data_equal(both):
    jdata, tdata, _, _ = both
    n = 0
    for path, want, got in _pairs(jdata, tdata):
        assert isinstance(got, torch.Tensor), path
        assert got.device.type == "cpu", path
        got = got.numpy()
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert np.array_equal(got, want), path
        n += 1
    assert n >= 30
    assert tdata["_worklist"].occupancy == jdata["_worklist"].occupancy
    for key in ("struct", "full_struct"):
        nbr = np.asarray(jdata[key]["in_nbr"])
        want = ell_transpose(nbr, nbr.shape[1] + 1)
        assert np.array_equal(tdata[key]["in_pos"].numpy(), want), key
        out = np.asarray(jdata[key]["out_nbr"])
        want = ell_transpose(out, int(out.max()) + 1)
        assert np.array_equal(tdata[key]["out_pos"].numpy(), want), key


def test_build_serve_plan_equal(both):
    jdata, tdata, _, _ = both
    jplan = jserving.build_serve_plan(jdata)
    tplan = tserving.build_serve_plan(tdata)
    for f in dataclasses.fields(jplan):
        a, b = getattr(jplan, f.name), getattr(tplan, f.name)
        if f.name == "pull":
            for pf in dataclasses.fields(a):
                pa, pb = getattr(a, pf.name), getattr(b, pf.name)
                assert np.array_equal(np.asarray(pa), np.asarray(pb)), pf.name
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for jd, td in ((jplan.query_data(), tplan.query_data("cpu")),
                   (jplan.refresh_data(), tplan.refresh_data("cpu"))):
        for path, want, got in _pairs(jd, td):
            assert np.array_equal(got.numpy(), want), path
