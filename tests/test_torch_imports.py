"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or the reference package, and its entry
points refuse a CUDA device that is not there instead of falling back."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    return ["repro_torch." + ".".join(p.relative_to(PORT).with_suffix("")
                                      .parts).replace(".__init__", "")
            for p in sorted(PORT.rglob("*.py"))]


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    return names


def test_port_sources_import_no_jax_and_no_reference():
    files = _port_files()
    assert len(files) > 20
    for path in files:
        for name in _imported(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_every_module_loads_no_jax():
    mods = _modules()
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core import serving
    from repro_torch.core.digest import prepare_graph_data
    from repro_torch.graph import make_dataset
    from repro_torch.launch import serve_gnn
    g = make_dataset("flickr-sim", scale=0.1, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_graph_data(g, 2, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        prepare_graph_data(g, 2)                        # the default
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.init_cache(serving.ServeConfig(), 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gnn.main(["--scale", "0.1"])


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without CUDA the smoke script fails and prints no result line; in a
    directory holding nothing else of the repo it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode != 0 and '"ok"' not in out.stdout
