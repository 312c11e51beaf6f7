"""TSDF fusion and mesh extraction on the volume's device (port of
``cut3r_slam_tpu/utils/tsdf.py``).

A sparse, block-hashed truncated signed distance field: 16^3-voxel blocks
live in one pool of tensors (SDF, weight, colour) on the device, and a
host dict maps each block key to its pool slot. A frame allocates the
blocks that its depth's truncation band reaches and fuses all of them in
one vectorized pass; ``extract_mesh`` runs marching tetrahedra over every
block at once. The semantics are those of the repository's C++ core
(``csrc/tsdf_core.cpp``: ``tsdf_integrate_block``, ``marching_tets_block``),
which the JAX module prefers over its numpy fallback: nearest-pixel
lookup by ``(int)(x + 0.5)``, the whole image as the bound, depths beyond
``depth_trunc`` rejected per voxel, and always a marching-tetrahedra mesh.
Voxels are indexed (z, y, x).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device

__all__ = ["TSDFVolume", "integrate_keyframes", "BLOCK"]

BLOCK = 16
# cube corner offsets (x, y, z) and the six tetrahedra around the 0-6
# diagonal (tsdf_core.cpp VOFF / TETS)
VOFF = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
        (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6),
        (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))
EDGES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# blocks fused / meshed per vectorized pass (bounds the temporaries)
CHUNK_BLOCKS = 1024
# block coordinates lie within +-2^20 (335 km at 2 cm voxels)
_KEY_OFF = 1 << 20


class TSDFVolume:
    def __init__(self, voxel_size: float = 0.02, trunc: float = 0.08,
                 max_weight: float = 64.0, device="cuda"):
        self.voxel_size = voxel_size
        self.trunc = trunc
        self.max_weight = max_weight
        self.device = resolve_device(device)
        self.slots: Dict[Tuple[int, int, int], int] = {}
        self.keys = torch.zeros(0, 3, dtype=torch.int64, device=self.device)
        self.sdf = torch.ones((0,) + (BLOCK,) * 3, device=self.device)
        self.weight = torch.zeros_like(self.sdf)
        self.color = torch.zeros(self.sdf.shape + (3,), device=self.device)

    # ------------------------------------------------------------------
    def _allocate(self, keys: torch.Tensor) -> torch.Tensor:
        """Pool slots of ``keys`` (n, 3), new blocks at sdf 1 / weight 0."""
        host = [tuple(k) for k in keys.tolist()]
        new = [k for k in host if k not in self.slots]
        if new:
            n0, n1 = len(self.slots), len(self.slots) + len(new)
            if n1 > self.sdf.shape[0]:
                cap = max(n1, 2 * self.sdf.shape[0], 64)
                grow = cap - self.sdf.shape[0]
                dev = self.device
                self.sdf = torch.cat([self.sdf, torch.ones(
                    (grow,) + (BLOCK,) * 3, device=dev)])
                self.weight = torch.cat([self.weight, torch.zeros(
                    (grow,) + (BLOCK,) * 3, device=dev)])
                self.color = torch.cat([self.color, torch.zeros(
                    (grow,) + (BLOCK,) * 3 + (3,), device=dev)])
            for i, k in enumerate(new):
                self.slots[k] = n0 + i
            self.keys = torch.cat([self.keys, torch.tensor(
                new, dtype=torch.int64, device=self.device)])
        return torch.tensor([self.slots[k] for k in host], dtype=torch.long,
                            device=self.device)

    def _candidate_keys(self, depth, K4, c2w, depth_trunc):
        """Blocks of the truncation band (-trunc, 0, +trunc) around every
        valid depth, in float64 as the JAX module's numpy."""
        v, u = torch.nonzero((depth > 0.01) & (depth < depth_trunc),
                             as_tuple=True)
        if v.numel() == 0:
            return None
        z = depth[v, u]
        fx, fy, cx, cy = (float(k) for k in K4[:4])
        c2w = torch.as_tensor(c2w, dtype=torch.float64, device=self.device)
        uf, vf = u.double(), v.double()
        keys = []
        for off in (-self.trunc, 0.0, self.trunc):
            zz = torch.clamp(z + off, min=1e-3).double()
            pts = torch.stack([(uf - cx) / fx * zz, (vf - cy) / fy * zz, zz],
                              -1)
            pts_w = pts @ c2w[:3, :3].T + c2w[:3, 3]
            keys.append(torch.floor(pts_w / (self.voxel_size * BLOCK)).long())
        # one int64 per key (21 bits a coordinate, offset to be positive):
        # a 1-D unique, in the (x, y, z) lexicographic order of np.unique
        k = torch.cat(keys) + _KEY_OFF
        code = torch.unique((k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2])
        mask = (1 << 21) - 1
        return torch.stack([code >> 42, (code >> 21) & mask, code & mask],
                           -1) - _KEY_OFF

    @torch.no_grad()
    def integrate(self, depth, color, K4, c2w, depth_trunc: float = 8.0):
        """Fuse one frame: depth (H, W) metric, color (H, W, 3) in [0, 1]
        or None, K4 = [fx, fy, cx, cy], c2w (4, 4)."""
        dev = self.device
        depth = torch.as_tensor(np.asarray(depth), device=dev)
        H, W = depth.shape
        c2w = np.asarray(c2w)
        keys = self._candidate_keys(depth, np.asarray(K4), c2w, depth_trunc)
        if keys is None:
            return
        slots = self._allocate(keys)
        d32 = depth.float().reshape(-1)
        rgb = (torch.as_tensor(np.asarray(color), device=dev).float()
               .reshape(-1, 3) if color is not None else None)
        K = [float(k) for k in np.asarray(K4[:4], np.float32)]
        w2c = np.linalg.inv(c2w).astype(np.float32).reshape(-1).tolist()
        for s in range(0, len(slots), CHUNK_BLOCKS):
            self._fuse(slots[s:s + CHUNK_BLOCKS], keys[s:s + CHUNK_BLOCKS],
                       d32, rgb, H, W, K, w2c, depth_trunc)

    def _fuse(self, slots, keys, depth, rgb, H, W, K, w, depth_trunc):
        """tsdf_integrate_block over the blocks ``slots`` at once, in f32
        with the core's order of operations."""
        fx, fy, cx, cy = K
        vox = self.voxel_size
        base = keys.float() * BLOCK * vox                        # (n, 3)
        off = (torch.arange(BLOCK, device=self.device).float() + 0.5) * vox
        wx = base[:, 0, None, None, None] + off[None, None, None, :]
        wy = base[:, 1, None, None, None] + off[None, None, :, None]
        wz = base[:, 2, None, None, None] + off[None, :, None, None]
        pcx = w[0] * wx + w[1] * wy + w[2] * wz + w[3]
        pcy = w[4] * wx + w[5] * wy + w[6] * wz + w[7]
        pcz = w[8] * wx + w[9] * wy + w[10] * wz + w[11]
        front = pcz > 0.01
        pcz_s = torch.where(front, pcz, torch.ones_like(pcz))
        u = (fx * pcx / pcz_s + cx + 0.5).to(torch.int32)
        v = (fy * pcy / pcz_s + cy + 0.5).to(torch.int32)
        ok = front & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        pix = (v.clamp(0, H - 1) * W + u.clamp(0, W - 1)).long()
        d = depth[pix]
        ok &= (d > 0.01) & (d <= depth_trunc)
        sdf = (d - pcz) / self.trunc
        ok &= sdf >= -1.0
        sdf = torch.clamp(sdf, max=1.0)

        w_old = self.weight[slots]
        denom = w_old + 1.0
        self.sdf[slots] = torch.where(
            ok, (self.sdf[slots] * w_old + sdf) / denom, self.sdf[slots])
        if rgb is not None:
            col = self.color[slots]
            self.color[slots] = torch.where(
                ok[..., None], (col * w_old[..., None] + rgb[pix])
                / denom[..., None], col)
        self.weight[slots] = torch.where(
            ok, torch.clamp(denom, max=self.max_weight), w_old)

    # ------------------------------------------------------------------
    def block_arrays(self):
        """{key: (sdf, weight, colour)} as host arrays, (z, y, x) voxels."""
        sdf, w, col = (t.cpu().numpy() for t in (self.sdf, self.weight,
                                                 self.color))
        return {k: (sdf[s], w[s], col[s]) for k, s in self.slots.items()}

    def _apron_grids(self, sl):
        """(n, 17, 17, 17) SDF and weight grids of the blocks ``sl``: the
        block, then a one-voxel apron from its +z, +y and +x neighbours;
        apron edges and corners stay at sdf 1 / weight 0."""
        n, N1 = len(sl), BLOCK + 1
        dev = self.device
        sdf_g = torch.ones(n, N1, N1, N1, device=dev)
        wgt_g = torch.zeros(n, N1, N1, N1, device=dev)
        sdf_g[:, :BLOCK, :BLOCK, :BLOCK] = self.sdf[sl]
        wgt_g[:, :BLOCK, :BLOCK, :BLOCK] = self.weight[sl]
        keys = self.keys[sl].tolist()
        for axis, (dx, dy, dz) in enumerate(((0, 0, 1), (0, 1, 0),
                                             (1, 0, 0))):
            nb = [self.slots.get((k[0] + dx, k[1] + dy, k[2] + dz), -1)
                  for k in keys]
            have = [i for i, s in enumerate(nb) if s >= 0]
            if not have:
                continue
            rows = torch.tensor(have, dtype=torch.long, device=dev)
            src = torch.tensor([nb[i] for i in have], dtype=torch.long,
                               device=dev)
            if axis == 0:
                sdf_g[rows, BLOCK, :BLOCK, :BLOCK] = self.sdf[src, 0]
                wgt_g[rows, BLOCK, :BLOCK, :BLOCK] = self.weight[src, 0]
            elif axis == 1:
                sdf_g[rows, :BLOCK, BLOCK, :BLOCK] = self.sdf[src, :, 0]
                wgt_g[rows, :BLOCK, BLOCK, :BLOCK] = self.weight[src, :, 0]
            else:
                sdf_g[rows, :BLOCK, :BLOCK, BLOCK] = self.sdf[src, :, :, 0]
                wgt_g[rows, :BLOCK, :BLOCK, BLOCK] = \
                    self.weight[src, :, :, 0]
        return sdf_g, wgt_g

    def _mesh_blocks(self, sl, min_weight):
        """marching_tets_block over the blocks ``sl`` at once: (verts
        (3 T, 3), colours (3 T, 3)), each triangle's three vertices in a
        row."""
        dev, vox = self.device, self.voxel_size
        sdf_g, wgt_g = self._apron_grids(sl)
        B = BLOCK
        corner_v = [sdf_g[:, oz:oz + B, oy:oy + B, ox:ox + B]
                    for ox, oy, oz in VOFF]
        ok = torch.ones(corner_v[0].shape, dtype=torch.bool, device=dev)
        for ox, oy, oz in VOFF:
            ok &= wgt_g[:, oz:oz + B, oy:oy + B, ox:ox + B] >= min_weight
        base = self.keys[sl].float() * BLOCK * vox + 0.5 * vox   # (n, 3)
        ia = torch.tensor([a for a, _ in EDGES], device=dev)
        ib = torch.tensor([c for _, c in EDGES], device=dev)
        tris, blk = [], []
        for tet in TETS:
            v = torch.stack([corner_v[c] for c in tet], -1)      # (n,B,B,B,4)
            neg = (v < 0).sum(-1)
            b, z, y, x = torch.nonzero(ok & (neg > 0) & (neg < 4),
                                       as_tuple=True)
            if b.numel() == 0:
                continue
            vv = v[b, z, y, x]                                   # (m, 4)
            cell = torch.stack([x, y, z], -1)
            off = torch.tensor([VOFF[c] for c in tet], device=dev)
            p = base[b][:, None, :] + (cell[:, None, :] + off[None]).float() \
                * vox                                            # (m, 4, 3)
            va, vb = vv[:, ia], vv[:, ib]                        # (m, 6)
            cross = (va < 0) != (vb < 0)
            t = torch.clamp((-va) / (vb - va + 1e-12), 0.0, 1.0)
            pts = p[:, ia] + t[..., None] * (p[:, ib] - p[:, ia])
            # the crossing edges in edge order: 3, or 4 (a quad)
            order = torch.argsort((~cross).to(torch.int32), dim=1,
                                  stable=True)[:, :4]
            q = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
            quad = cross.sum(1) == 4
            tris.append(q[:, [0, 1, 2]])
            blk.append(b)
            tris.append(q[quad][:, [1, 3, 2]])
            blk.append(b[quad])
        if not tris:
            z = torch.zeros(0, 3, device=dev)
            return z, z
        verts = torch.cat(tris).reshape(-1, 3)
        vb_ = torch.cat(blk).repeat_interleave(3)
        vi = torch.clamp(((verts - base[vb_]) / vox).to(torch.int32), 0,
                         BLOCK - 1).long()
        cols = self.color[sl][vb_, vi[:, 2], vi[:, 1], vi[:, 0]]
        return verts, cols

    @torch.no_grad()
    def extract_mesh(self, min_weight: float = 1.0):
        """Marching tetrahedra over every block: (verts (V, 3), faces
        (V / 3, 3), colours (V, 3)) as host arrays."""
        n = len(self.slots)
        vs, cs = [], []
        for s in range(0, n, CHUNK_BLOCKS):
            sl = torch.arange(s, min(n, s + CHUNK_BLOCKS), device=self.device)
            v, c = self._mesh_blocks(sl, min_weight)
            vs.append(v)
            cs.append(c)
        if not vs or sum(len(v) for v in vs) == 0:
            return np.zeros((0, 3), np.float32), None, \
                np.zeros((0, 3), np.float32)
        verts = torch.cat(vs).cpu().numpy()
        cols = torch.cat(cs).cpu().numpy()
        faces = np.arange(len(verts)).reshape(-1, 3)
        return verts, faces, cols

    def save_ply(self, path: str, min_weight: float = 1.0):
        """ASCII ply of the mesh (the JAX module's writer); returns the
        vertex count."""
        verts, faces, cols = self.extract_mesh(min_weight)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        c8 = np.clip(cols * 255, 0, 255).astype(int).tolist()
        lines = ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
                 "property float x", "property float y", "property float z",
                 "property uchar red", "property uchar green",
                 "property uchar blue"]
        if faces is not None:
            lines += [f"element face {len(faces)}",
                      "property list uchar int vertex_indices"]
        lines.append("end_header")
        lines += [f"{v[0]:.4f} {v[1]:.4f} {v[2]:.4f} {c[0]} {c[1]} {c[2]}"
                  for v, c in zip(verts.tolist(), c8)]
        if faces is not None:
            lines += [f"3 {a} {b} {c}" for a, b, c in faces.tolist()]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return len(verts)


def integrate_keyframes(depths, colors, K4, c2ws, voxel_size: float = 0.02,
                        out_ply: Optional[str] = None, device="cuda"
                        ) -> TSDFVolume:
    """Fuse rendered keyframes (``tsdf_integrate.py``'s loop) into a new
    volume with trunc = 4 voxels; optionally write its mesh."""
    vol = TSDFVolume(voxel_size=voxel_size, trunc=4 * voxel_size,
                     device=device)
    for i in range(len(depths)):
        vol.integrate(depths[i], colors[i] if colors is not None else None,
                      K4, c2ws[i])
    if out_ply:
        vol.save_ply(out_ply)
    return vol
