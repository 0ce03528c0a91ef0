"""The kernel build step (``repro_torch.kernels._build.build``) on the
CPU, with a stand-in for ``nvcc``: every missing source is compiled in
parallel, each timed on its own, its compiler log kept, a built library
reused, and a failed compile raised with its log.  The real ``nvcc`` runs
only on the card's machine (``chip_smoke.py``)."""
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build

FAKE_NVCC = """#!{python}
import sys, time
args = sys.argv[1:]
src = args[-1]
time.sleep(1.0 if "slow" in src else 0.0)
print("ptxas info    : Compiling entry function 'k' for 'sm_90a'")
print("ptxas info    : Used 42 registers")
if "broken" in src:
    print(src + ": error: expected a ';'")
    sys.exit(2)
open(args[args.index("-o") + 1], "w").write("lib")
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text("// shared\n")
    for name in ("fast", "slow", "broken"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    return tmp_path


def test_build_times_each_source_and_keeps_its_log(tree):
    out = _build.build(("fast", "slow"))
    assert sorted(out) == ["fast", "slow"]
    for name, info in out.items():
        assert _build._target(name).exists()
        assert info["path"] == str(_build._target(name))
        assert "Used 42 registers" in info["log"]
    assert 0 < out["fast"]["seconds"] < out["slow"]["seconds"]
    assert not list((tree / "build").glob("*.log"))
    assert not list((tree / "build").glob("*.tmp*"))
    assert _build.build(("fast", "slow")) == {}      # nothing to rebuild


def test_build_raises_with_the_compiler_log(tree):
    with pytest.raises(RuntimeError, match="broken.cu.*expected a"):
        _build.build(("fast", "broken"))
    assert _build._target("fast").exists()
    assert not _build._target("broken").exists()
    assert not list((tree / "build").glob("*.tmp*"))
