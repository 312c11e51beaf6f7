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


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU work (under ``pytest -n``
    every worker's default pool spans all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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
    # the mono prior, the CroCo / DUSt3R / Spann3R families and the
    # stereo / flow harness are modules of the port
    assert {f"cut3r_slam_tpu_torch.{m}" for m in (
        "models.priors", "models.omnidata", "models.croco_pretrain",
        "models.dust3r_pair", "models.spann3r", "datasets.pairs",
        "train.stereoflow")} <= set(names)
    # the DROID stack, the shared math and the viewer
    assert {f"cut3r_slam_tpu_torch.{m}" for m in (
        "geometry.projective", "geometry.sim3_align", "ops.corr", "ops.ba",
        "ops.imageproc", "models.droid_net", "gui.server")} <= set(names)
    # the scale-out over torch.distributed
    assert {f"cut3r_slam_tpu_torch.parallel.{m}" for m in (
        "mesh", "mapping", "inference")} <= set(names)
    # the benchmark driver and the host tools
    assert {f"cut3r_slam_tpu_torch.{m}" for m in (
        "bench", "pose_convert", "generate_synth_scenes")} <= set(names)
    assert build._LOADED == {}


def test_parallel_loads_no_jax():
    """``parallel/`` and the modules it wires into pull neither JAX nor
    the JAX package into a fresh interpreter (the spawned ranks of the
    parallel tests import them; this process has JAX loaded already)."""
    import subprocess
    import sys
    code = ("import sys, cut3r_slam_tpu_torch.parallel.mesh, "
            "cut3r_slam_tpu_torch.parallel.mapping, "
            "cut3r_slam_tpu_torch.parallel.inference, "
            "cut3r_slam_tpu_torch.slam.system, "
            "cut3r_slam_tpu_torch.train.trainer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


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
    from cut3r_slam_tpu_torch.utils.tsdf import TSDFVolume
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TSDFVolume()
    from cut3r_slam_tpu_torch.models.droid_net import DroidNet
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DroidNet()


@pytest.mark.parametrize("caller", [True, False])
def test_full_f32_turns_cudnn_off_inside_only(caller):
    """``full_f32`` runs convolutions without cuDNN (its float32 backward
    algorithms are not float32-accurate) and restores the caller's
    setting after, whatever it was."""
    before = torch.backends.cudnn.enabled
    try:
        torch.backends.cudnn.enabled = caller
        with cut3r_slam_tpu_torch.full_f32():
            assert torch.backends.cudnn.enabled is False
        assert torch.backends.cudnn.enabled is caller
    finally:
        torch.backends.cudnn.enabled = before


def test_full_f32_blocks_overlapping_across_threads():
    """Blocks in two threads that overlap without nesting (the viewer's
    render beside the loop): the settings stay off until the last block
    leaves, then the caller's come back, whatever the order of exits."""
    import threading
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [f.allow_tf32 for f in flags] + [torch.backends.cudnn.enabled]
    entered, release = threading.Event(), threading.Event()

    def other():
        with cut3r_slam_tpu_torch.full_f32():
            entered.set()
            release.wait(10)

    try:
        for f in flags:
            f.allow_tf32 = True
        torch.backends.cudnn.enabled = True
        th = threading.Thread(target=other)
        with cut3r_slam_tpu_torch.full_f32():
            th.start()
            assert entered.wait(10)
        # this thread left first: the other block still runs in f32
        assert [f.allow_tf32 for f in flags] == [False, False]
        assert torch.backends.cudnn.enabled is False
        release.set()
        th.join(10)
        assert [f.allow_tf32 for f in flags] == [True, True]
        assert torch.backends.cudnn.enabled is True
    finally:
        release.set()
        for f, b in zip(flags, before):
            f.allow_tf32 = b
        torch.backends.cudnn.enabled = before[2]
