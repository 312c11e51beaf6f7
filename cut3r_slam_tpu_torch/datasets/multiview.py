"""Multi-view training dataset framework (port of
``cut3r_slam_tpu/datasets/multiview.py``, numpy, the same draws).

Multi-view sampling (video clips and unordered collections), seeded
determinism, and the ``@`` replication / ``+`` concatenation combinators
used to mix training sets. ``make_batch_iter`` collates samples into the
batches ``train/train_step.py`` takes, with the ground-truth pointmaps
computed by the geometry package on the CPU (f32).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..utils.image import _resize

__all__ = ["EasyDataset", "MultiViewDataset", "CatDataset", "MulDataset",
           "sample_view_offsets", "make_batch_iter"]


class EasyDataset:
    """Combinators: ``ds @ k`` replicates, ``ds + ds2`` concatenates
    (the upstream easy_dataset.py semantics)."""

    def __add__(self, other):
        return CatDataset([self, other])

    def __matmul__(self, k: int):
        return MulDataset(self, k)

    def __rmatmul__(self, k: int):
        return MulDataset(self, k)


class MulDataset(EasyDataset):
    def __init__(self, ds, mult: int):
        self.ds = ds
        self.mult = int(mult)

    def __len__(self):
        return self.mult * len(self.ds)

    def __getitem__(self, i):
        return self.ds[i % len(self.ds)]


class CatDataset(EasyDataset):
    def __init__(self, parts: List):
        flat = []
        for p in parts:
            flat.extend(p.parts if isinstance(p, CatDataset) else [p])
        self.parts = flat
        self._sizes = np.cumsum([len(p) for p in flat])

    def __len__(self):
        return int(self._sizes[-1])

    def __getitem__(self, i):
        j = int(np.searchsorted(self._sizes, i, side="right"))
        off = 0 if j == 0 else int(self._sizes[j - 1])
        return self.parts[j][i - off]


def sample_view_offsets(rng, num_views: int, span: int,
                        max_interval: int = 25, video_prob: float = 0.5,
                        fix_interval_prob: float = 0.5,
                        block_shuffle: int = 16) -> np.ndarray:
    """Reference sequence sampler (base_multiview_dataset.py:178-260):
    with prob ``video_prob`` draw an ordered video clip (fixed stride
    with prob ``fix_interval_prob``, else random strides); otherwise an
    unordered collection, lightly shuffled within ``block_shuffle``-sized
    blocks. Returns non-decreasing-capped offsets into [0, span)."""
    max_interval = max(1, min(max_interval, span // max(num_views - 1, 1)))
    if rng.random() < video_prob:
        if rng.random() < fix_interval_prob:
            stride = int(rng.integers(1, max_interval + 1))
            offs = np.arange(num_views) * stride
        else:
            offs = np.concatenate(
                [[0], np.cumsum(rng.integers(1, max_interval + 1,
                                             num_views - 1))])
        return np.minimum(offs, span - 1)
    # always return exactly num_views offsets (replace=True once the
    # span is exhausted) so fixed-V batch collation never sees a ragged
    # view tuple
    offs = np.sort(rng.choice(span, size=num_views,
                              replace=num_views > span))
    if block_shuffle and num_views > block_shuffle:
        for s in range(0, num_views, block_shuffle):
            rng.shuffle(offs[s:s + block_shuffle])
    return offs


@dataclasses.dataclass
class MultiViewDataset(EasyDataset):
    """Sample V-view tuples from an RGB-D sequence.

    source: indexable with dict items {image, depth?, pose? | pose_c2w?,
    K4, scene?}; num_views: views per sample; span: max temporal distance
    between the first and last view; resolution: (H, W) output (from the
    reference's resolution pool concept — one fixed pool entry per
    dataset instance). Sampling follows the reference's video /
    collection mix (sample_view_offsets); views never cross a scene
    boundary when the source labels items with ``scene``.
    """
    source: object
    num_views: int = 4
    span: int = 24
    resolution: Tuple[int, int] = (224, 224)
    seed: int = 777
    max_interval: int = 25
    video_prob: float = 0.5
    fix_interval_prob: float = 0.5

    def __len__(self):
        return max(len(self.source) - self.span, 1)

    def __getitem__(self, i: int) -> List[Dict]:
        rng = np.random.default_rng(self.seed + i)
        start = i % max(len(self.source) - self.span, 1)
        offs = sample_view_offsets(rng, self.num_views, self.span,
                                   self.max_interval, self.video_prob,
                                   self.fix_interval_prob)
        views = []
        H, W = self.resolution
        scene0 = None
        last_good = None
        for o in offs:
            item = self.source[int(start + o)]
            if scene0 is None:
                scene0 = item.get("scene")
            elif item.get("scene") != scene0 and last_good is not None:
                item = last_good  # clamp at the scene boundary
            last_good = item
            img = _resize(item["image"], W, H)
            view = {"img": (np.asarray(img, np.float32) / 255.0 - 0.5) / 0.5}
            h0, w0 = item["image"].shape[:2]
            sx, sy = W / w0, H / h0
            K4 = np.asarray(item["K4"], np.float32)
            view["K4"] = np.asarray(
                [K4[0] * sx, K4[1] * sy, K4[2] * sx, K4[3] * sy], np.float32)
            if "depth" in item:
                try:
                    import cv2
                    d = cv2.resize(item["depth"], (W, H),
                                   interpolation=cv2.INTER_NEAREST)
                except ImportError:
                    d = np.asarray(item["depth"])[
                        (np.linspace(0, h0 - 1, H).astype(int)[:, None],
                         np.linspace(0, w0 - 1, W).astype(int)[None, :])]
                view["depth"] = np.asarray(d, np.float32)
            if "pose" in item:
                view["pose"] = np.asarray(item["pose"], np.float32)
            elif "pose_c2w" in item:
                # 4x4 c2w -> [t, q xyzw] (loaders.py sources)
                from scipy.spatial.transform import Rotation
                m = np.asarray(item["pose_c2w"], np.float64)
                q = Rotation.from_matrix(m[:3, :3]).as_quat()
                view["pose"] = np.concatenate(
                    [m[:3, 3], q]).astype(np.float32)
            views.append(view)
        return views


def make_batch_iter(dataset, batch_size: int = 1, seed: int = 0
                    ) -> Iterator[Dict[str, np.ndarray]]:
    """Yield CUT3R training batches (train/train_step.py format):
    imgs (V,B,H,W,3), pts3d (V,B,H,W,3), camera_pose (V,B,4,4),
    valid_mask (V,B,H,W), img (V,B,H,W,3)."""
    import torch
    from ..geometry.pointmap import depth_to_pointmap, pose_vec_to_matrix

    rng = np.random.default_rng(seed)
    while True:
        samples = [dataset[int(rng.integers(len(dataset)))]
                   for _ in range(batch_size)]
        V = len(samples[0])
        imgs, pts, poses, valid = [], [], [], []
        for v in range(V):
            imgs.append(np.stack([s[v]["img"] for s in samples]))
            c2w = np.stack([pose_vec_to_matrix(torch.from_numpy(
                s[v]["pose"])).numpy() for s in samples])
            poses.append(c2w)
            pm, vm = [], []
            for b, s in enumerate(samples):
                d = s[v]["depth"]
                pm.append(depth_to_pointmap(
                    torch.from_numpy(d), torch.from_numpy(s[v]["K4"]),
                    c2w=torch.from_numpy(c2w[b])).numpy())
                vm.append(d > 0)
            pts.append(np.stack(pm))
            valid.append(np.stack(vm))
        yield {"imgs": np.stack(imgs), "pts3d": np.stack(pts),
               "camera_pose": np.stack(poses),
               "valid_mask": np.stack(valid), "img": np.stack(imgs)}
