import os

# Tests see exactly ONE device by default (the dry-run sets 512 in its
# own process); keep any inherited XLA_FLAGS out.  The CI collective job
# opts into N forced host devices via REPRO_HOST_DEVICES so the sharded
# pull/push paths run in-process (see test_sharded_pull.py).
os.environ.pop("XLA_FLAGS", None)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
_n_dev = os.environ.get("REPRO_HOST_DEVICES")
if _n_dev:
    os.environ["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={_n_dev}"

import functools
import inspect
import random
import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Minimal deterministic `hypothesis` stand-in.
#
# The container has no hypothesis wheel and nothing may be pip-installed;
# rather than skip the property tests, provide the tiny subset they use
# (given / settings / strategies.integers / strategies.sampled_from) drawing
# `max_examples` pseudo-random examples from a fixed seed.  If the real
# hypothesis is installed (e.g. in CI) it is used untouched.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(min_value, max_value):
        return _Strategy(lambda r: r.randint(min_value, max_value))

    def _sampled_from(elements):
        elements = list(elements)
        return _Strategy(lambda r: r.choice(elements))

    def _given(**strategies):
        def deco(fn):
            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                n = getattr(wrapper, "_max_examples", 10)
                rng = random.Random(0xD16E57)
                for _ in range(n):
                    drawn = {k: s.draw(rng) for k, s in strategies.items()}
                    fn(*args, **drawn, **kwargs)
            # Hide the drawn params from pytest's fixture resolution.
            sig = inspect.signature(fn)
            params = [p for name, p in sig.parameters.items()
                      if name not in strategies]
            wrapper.__signature__ = sig.replace(parameters=params)
            del wrapper.__wrapped__
            return wrapper
        return deco

    def _settings(max_examples=10, **_ignored):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


# ---------------------------------------------------------------------------
# CI leg partition markers.
#
# tests/ci_legs.py is the single source of truth for which 8-device CI
# leg owns each test file; the hooks below register the markers, stamp
# every collected test with its leg's derived ``leg_<name>`` marker
# (so the workflow selects with ``pytest -m leg_<name>`` instead of an
# --ignore list), and skip ``forced_devices(n)`` tests when the forced
# host platform is smaller than n.
# ---------------------------------------------------------------------------
from ci_legs import ALL_LEGS, leg_for, marker_name  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "leg(name): CI leg that owns this test file (see tests/ci_legs.py; "
        "checked against the registry by scripts/check_test_partition.py)")
    config.addinivalue_line(
        "markers",
        "forced_devices(n): requires >= n forced host devices "
        "(REPRO_HOST_DEVICES); skipped on smaller platforms")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skipped "
        "where torch.cuda.is_available() is false")
    for leg in ALL_LEGS:
        config.addinivalue_line(
            "markers",
            f"{marker_name(leg)}: derived — tests owned by the "
            f"'{leg}' CI leg (stamped from tests/ci_legs.py)")


def pytest_collection_modifyitems(config, items):
    num_devices = int(os.environ.get("REPRO_HOST_DEVICES", "1"))
    for item in items:
        stem = os.path.splitext(os.path.basename(str(item.fspath)))[0]
        declared = item.get_closest_marker("leg")
        leg = declared.args[0] if declared else leg_for(stem)
        item.add_marker(getattr(pytest.mark, marker_name(leg)))
        forced = item.get_closest_marker("forced_devices")
        if forced and num_devices < int(forced.args[0]):
            item.add_marker(pytest.mark.skip(
                reason=f"needs {forced.args[0]} forced host devices "
                       f"(REPRO_HOST_DEVICES={num_devices})"))
