"""The PyTorch port stands alone: no module of ``cut3r_slam_tpu_torch`` (nor
``chip_smoke.py``) imports jax, flax or the JAX package, importing the
package builds no kernel, and its entry points refuse a missing GPU."""
import ast
import importlib
import pathlib
import pkgutil

import pytest
import torch

import cut3r_slam_tpu_torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cut3r_slam_tpu")
SOURCES = sorted((ROOT / "cut3r_slam_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_without_building():
    from cut3r_slam_tpu_torch.kernels import build
    names = [m.name for m in pkgutil.walk_packages(
        cut3r_slam_tpu_torch.__path__, "cut3r_slam_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    assert len(names) >= 25
    assert build._LOADED == {}


def test_entry_points_refuse_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from cut3r_slam_tpu_torch.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu_torch.slam import MappingBackend, MappingConfig
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CUT3R(CUT3RConfig.tiny())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MappingBackend(MappingConfig(height=16, width=16, capacity=64,
                                     cam_capacity=2), [10, 10, 8, 8])
