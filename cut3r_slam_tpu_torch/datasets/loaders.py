"""Concrete multi-view training dataset sources (port of
``cut3r_slam_tpu/datasets/loaders.py``, numpy).

The upstream project has one torch Dataset per preprocessed source (its
36 training sets). All share one shape: enumerate scenes under ROOT,
enumerate frames inside each scene by a filename pattern, and per view
read (rgb, depth, cam.npz) with dataset-specific depth decoding (scale /
sky mask / percentile clip / constant-depth RGB-only sets). Here that
shape is data: a ``SceneLayout`` spec per dataset and one generic
``SceneFolderSource`` reader; CO3D-family sets get ``Co3dSource``. The
multi-view sequence sampler is in ``datasets/multiview.py``.
"""
from __future__ import annotations

import dataclasses
import glob
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..utils.image import _imread

__all__ = ["SceneLayout", "SceneFolderSource", "SCENE_LAYOUTS",
           "make_source", "list_datasets"]


def _read_depth_file(path: str) -> np.ndarray:
    """npy / 16-bit png / exr depth reader."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    try:
        import cv2
        d = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if d is None:
            raise FileNotFoundError(path)
    except ImportError:
        from PIL import Image
        d = np.asarray(Image.open(path))
    if d.ndim == 3:
        d = d[..., 0]
    return d.astype(np.float32)


def _cam_from_npz(cam: Dict) -> Dict[str, np.ndarray]:
    """Normalize the cam.npz key variants used across the 36 sets:
    intrinsics|camera_intrinsics (3,3), pose|camera_pose (4,4) or
    R_cam2world + t_cam2world (blendedmvs.py:277-278)."""
    K = None
    for k in ("intrinsics", "camera_intrinsics"):
        if k in cam:
            K = np.asarray(cam[k], np.float32)
            break
    pose = None
    for k in ("pose", "camera_pose"):
        if k in cam:
            pose = np.asarray(cam[k], np.float32)
            break
    if pose is None and "R_cam2world" in cam:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = cam["R_cam2world"]
        pose[:3, 3] = cam["t_cam2world"].reshape(3)
    out = {}
    if K is not None:
        out["K4"] = np.asarray([K[0, 0], K[1, 1], K[0, 2], K[1, 2]],
                               np.float32)
    if pose is not None:
        out["c2w"] = pose
    return out


@dataclasses.dataclass(frozen=True)
class SceneLayout:
    """Directory conventions + depth decoding for one dataset family."""
    name: str
    rgb: str = "rgb/{frame}.png"
    depth: Optional[str] = "depth/{frame}.npy"
    cam: str = "cam/{frame}.npz"
    scene_depth: int = 1            # ROOT/scene vs ROOT/scene/sub nesting
    depth_scale: float = 1.0        # divide raw depth by this
    depth_clip: float = 0.0         # depth > clip -> invalid 0 (0 = off)
    sky_threshold: float = 0.0      # depth >= thr -> sky (-1) (0 = off)
    percentile_clip: bool = False   # > p98 of valid -> 0 (tartanair.py:127)
    is_metric: bool = True
    max_interval: int = 8

    def frame_names(self, scene_dir: str) -> List[str]:
        pat = self.rgb.replace("{frame}", "*")
        paths = sorted(glob.glob(osp.join(scene_dir, pat)))
        pre, post = self.rgb.split("{frame}")
        return [p[len(osp.join(scene_dir, "")) + len(pre):
                  len(p) - len(post)] for p in paths]


class SceneFolderSource:
    """Indexable (image, depth, pose, K4) source over all scenes of a
    layout — the plug-in format of datasets/multiview.MultiViewDataset."""

    def __init__(self, root: str, layout: SceneLayout,
                 scenes: Optional[List[str]] = None):
        self.root = root
        self.layout = layout
        if scenes is None:
            pat = osp.join(root, *(["*"] * layout.scene_depth))
            scenes = sorted(d for d in glob.glob(pat) if osp.isdir(d))
        else:
            scenes = [osp.join(root, s) for s in scenes]
        self.items: List = []           # (scene_dir, frame_name)
        self.scene_of: List[int] = []   # item -> scene index (sampler bound)
        for si, sd in enumerate(scenes):
            for fn in layout.frame_names(sd):
                self.items.append((sd, fn))
                self.scene_of.append(si)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict:
        lay = self.layout
        sd, fn = self.items[i]
        img = _imread(osp.join(sd, lay.rgb.format(frame=fn)))
        out = {"t": i, "image": img, "scene": self.scene_of[i]}
        out.update(_cam_from_npz(
            dict(np.load(osp.join(sd, lay.cam.format(frame=fn))))))
        if "c2w" in out:
            out["pose_c2w"] = out.pop("c2w")
        if lay.depth is None:
            # RGB-only sets train pose/rgb heads with unit depth
            # (realestate10k.py:104, mvimgnet.py:106)
            out["depth"] = np.ones(img.shape[:2], np.float32)
            return out
        d = _read_depth_file(osp.join(sd, lay.depth.format(frame=fn)))
        d = d / lay.depth_scale
        d = np.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
        if lay.sky_threshold > 0:
            d = np.where(d >= lay.sky_threshold, -1.0, d)
        if lay.percentile_clip:
            valid = d[d > 0]
            if valid.size:
                d = np.where(d > np.percentile(valid, 98), 0.0, d)
        if lay.depth_clip > 0:
            d = np.where(d > lay.depth_clip, 0.0, d)
        out["depth"] = d.astype(np.float32)
        return out


# ---------------------------------------------------------------------------
# the layout registry — one spec per reference loader (citations per entry)
# ---------------------------------------------------------------------------

_L = SceneLayout
SCENE_LAYOUTS: Dict[str, SceneLayout] = {
    # arkitscenes.py:202-209 (vga_wide jpg + lowres_depth mm png)
    "arkitscenes": _L("arkitscenes", rgb="vga_wide/{frame}.jpg",
                      depth="lowres_depth/{frame}.png",
                      cam="cam/{frame}.npz",
                      depth_scale=1000.0, max_interval=8),
    # arkitscenes_highres.py:135-142
    "arkitscenes_highres": _L("arkitscenes_highres",
                              rgb="vga_wide/{frame}.jpg",
                              depth="highres_depth/{frame}.png",
                              cam="cam/{frame}.npz",
                              depth_scale=1000.0, max_interval=8),
    # bedlam.py:259-265
    "bedlam": _L("bedlam", max_interval=4),
    # blendedmvs.py:271-278 (flat scene dir; exr depth; R/t cam keys)
    "blendedmvs": _L("blendedmvs", rgb="{frame}.jpg", depth="{frame}.exr",
                     cam="{frame}.npz", is_metric=False),
    # dl3dv.py:112-119 (images_4 png + npy depth)
    "dl3dv": _L("dl3dv", rgb="images_4/{frame}.png",
                depth="depth/{frame}.npy", cam="cam/{frame}.npz",
                is_metric=False, max_interval=20),
    # dynamic_replica.py:99-104
    "dynamic_replica": _L("dynamic_replica", max_interval=16),
    # eden.py:52-61
    "eden": _L("eden", max_interval=4),
    # hoi4d.py:50-54 (pose-free: cam npz holds intrinsics only)
    "hoi4d": _L("hoi4d", max_interval=4),
    # hypersim.py:101-105 (flat files <frame>_rgb.png etc.)
    "hypersim": _L("hypersim", rgb="{frame}rgb.png",
                   depth="{frame}depth.npy", cam="{frame}cam.npz",
                   scene_depth=2, max_interval=4),
    # irs.py:50-53
    "irs": _L("irs", max_interval=4),
    # mapfree.py:232-236
    "mapfree": _L("mapfree", rgb="rgb/{frame}.jpg", max_interval=30),
    # megadepth.py:67-69 (exr depth, non-metric SfM scale)
    "megadepth": _L("megadepth", rgb="{frame}.jpg", depth="{frame}.exr",
                    cam="{frame}.npz", is_metric=False),
    # mp3d.py:91-96
    "mp3d": _L("mp3d", max_interval=8),
    # mvimgnet.py:104-107 (RGB-only; unit depth)
    "mvimgnet": _L("mvimgnet", rgb="rgb/{frame}.jpg", depth=None,
                   is_metric=False, max_interval=32),
    # mvs_synth.py:98-110 (synthetic city; far plane clipped)
    "mvs_synth": _L("mvs_synth", rgb="rgb/{frame}.jpg",
                    is_metric=False, max_interval=4, depth_clip=80.0),
    # omniobject3d.py:108-115 (mm depth at object scale)
    "omniobject3d": _L("omniobject3d", depth_scale=1000.0,
                       is_metric=False, max_interval=4),
    # pointodyssey.py:139-145
    "pointodyssey": _L("pointodyssey", rgb="rgb/{frame}.jpg",
                       scene_depth=2, max_interval=4),
    # realestate10k.py:102-105 (RGB-only)
    "realestate10k": _L("realestate10k", depth=None, is_metric=False,
                        max_interval=128),
    # scannet.py:107-115
    "scannet": _L("scannet", rgb="color/{frame}.jpg",
                  depth="depth/{frame}.png", depth_scale=1000.0,
                  max_interval=30),
    # scannetpp.py:153-158
    "scannetpp": _L("scannetpp", rgb="images/{frame}.jpg",
                    depth="depth/{frame}.png", depth_scale=1000.0,
                    max_interval=3),
    # smartportraits.py:50-54
    "smartportraits": _L("smartportraits", max_interval=4),
    # spring.py:99-104
    "spring": _L("spring", max_interval=16),
    # synscapes.py:44-52 (flat; sky via aux mask -> threshold fallback)
    "synscapes": _L("synscapes", scene_depth=0, depth_clip=200.0,
                    max_interval=4),
    # tartanair.py:116-132 (flat *_rgb.png; sky >= 1000; p98 clip)
    "tartanair": _L("tartanair", rgb="{frame}_rgb.png",
                    depth="{frame}_depth.npy", cam="{frame}_cam.npz",
                    scene_depth=3, sky_threshold=1000.0,
                    percentile_clip=True, max_interval=20),
    # threedkb.py:78-82 (exr mm depth, clip 20m)
    "threedkb": _L("threedkb", rgb="rgb/{frame}.png",
                   depth="depth/{frame}.exr", depth_scale=1000.0,
                   depth_clip=20.0, is_metric=False, max_interval=4),
    # uasol.py:109-115 (>= 20m invalid)
    "uasol": _L("uasol", depth_clip=20.0, max_interval=40),
    # unreal4k.py:112-125
    "unreal4k": _L("unreal4k", rgb="{frame}_rgb.png",
                   depth="{frame}_depth.npy", cam="{frame}.npz",
                   sky_threshold=1000.0, percentile_clip=True,
                   max_interval=2),
    # urbansyn.py:41-49
    "urbansyn": _L("urbansyn", scene_depth=0, depth_clip=200.0,
                   max_interval=4),
    # vkitti2.py:123-137 (cm png depth; sky 655.35m)
    "vkitti2": _L("vkitti2", rgb="{frame}_rgb.jpg",
                  depth="{frame}_depth.png", cam="{frame}_cam.npz",
                  scene_depth=2, depth_scale=100.0, sky_threshold=655.0,
                  max_interval=5),
    # waymo.py:141-143
    "waymo": _L("waymo", rgb="{frame}.jpg", depth="{frame}.exr",
                cam="{frame}.npz", percentile_clip=True, max_interval=8),
    # wildrgbd.py:33-48 (co3d layout, metric mm depth)
    "wildrgbd": _L("wildrgbd", rgb="rgb/{frame}.jpg",
                   depth="depth/{frame}.png", cam="metadata/{frame}.npz",
                   scene_depth=2, depth_scale=1000.0, max_interval=16),
}


class Co3dSource(SceneFolderSource):
    """CO3D-family: ROOT/<category>/<instance>/images/frame*.jpg with
    per-frame metadata npz and 16-bit depth normalized by maximum_depth
    (co3d.py:49-65). cop3d (cop3d.py:31-34) is the RGB-only variant."""

    def __init__(self, root: str, with_depth: bool = True):
        lay = SceneLayout("co3d", rgb="images/{frame}.jpg",
                          depth="depths/{frame}.jpg.geometric.png"
                          if with_depth else None,
                          cam="images/{frame}.npz", scene_depth=2,
                          is_metric=False, max_interval=16)
        super().__init__(root, lay)
        self.with_depth = with_depth

    def __getitem__(self, i: int) -> Dict:
        sd, fn = self.items[i]
        img = _imread(osp.join(sd, "images", f"{fn}.jpg"))
        meta = dict(np.load(osp.join(sd, "images", f"{fn}.npz")))
        out = {"t": i, "image": img, "scene": self.scene_of[i]}
        out.update({k if k != "c2w" else "pose_c2w": v
                    for k, v in _cam_from_npz(meta).items()})
        if self.with_depth:
            dpath = osp.join(sd, "depths", f"{fn}.jpg.geometric.png")
            d = _read_depth_file(dpath) / 65535.0
            d *= float(np.nan_to_num(meta.get("maximum_depth", 1.0)))
            out["depth"] = np.nan_to_num(d, nan=0.0, posinf=0.0,
                                         neginf=0.0).astype(np.float32)
        else:
            out["depth"] = np.ones(img.shape[:2], np.float32)
        return out


def make_source(name: str, root: str, **kw):
    """Instantiate a dataset source by reference name."""
    if name == "co3d":
        return Co3dSource(root, with_depth=True, **kw)
    if name == "cop3d":
        return Co3dSource(root, with_depth=False, **kw)
    if name not in SCENE_LAYOUTS:
        raise ValueError(f"unknown dataset '{name}'; "
                         f"options: {sorted(list_datasets())}")
    return SceneFolderSource(root, SCENE_LAYOUTS[name], **kw)


def list_datasets() -> List[str]:
    return sorted(set(SCENE_LAYOUTS) | {"co3d", "cop3d"})
