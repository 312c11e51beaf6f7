"""View-parallel Gaussian mapping over a process group (port of
``cut3r_slam_tpu/parallel/mapping.py``).

The window optimization, the global-BA batch and the batched pose
refinement each render a set of views whose losses are independent given
the Gaussians: the window loss is a weighted SUM of per-view losses, the
global-BA batch sums its views' gradients and statistics, and each
refined view is its own pose problem. So every rank of the mesh's ``mv``
axis holds the whole arena (replicated and equal on every rank) and
renders its contiguous slice of the views (``torch.tensor_split``: no
zero-weight padding, a rank may hold no view and still joins each
collective):

* ``make_parallel_optimize``: per iteration the rank's raw loss and
  gradients (``MappingBackend._window_loss_raw``), then ONE ``all_reduce``
  of one flat buffer holding the Gaussian gradients, the loss sum and the
  weight sum (the JAX package's single ``psum``); division by the global
  weight sum gives the sequential ``_window_loss``'s gradient, Adam runs
  replicated on every rank, the views' pose deltas and exposures stay
  with their rank and their rows are gathered into every rank's
  ``CameraBuffer`` at each ``opt_segment``'s end;
* ``make_parallel_gba_batch``: each rank renders its share of the k
  views against the block's cached bins of those views (the JAX parallel
  batch re-bins them; keeping them stays closer to the sequential path),
  the summed gradients and densification statistics are summed and the
  radii maxed over the ranks, and the per-view outputs gathered;
* ``make_parallel_pose_refine``: each rank refines its views with no
  collective inside the iterations, then the poses, scaled depths,
  pointmaps and validity masks are gathered.

Math identity: sequential loss = (sum_i w_i l_i) / sum_i w_i; the split
over ranks reorders the outer sum only (tests/test_torch_parallel_mapping.py
holds both paths and the JAX package's mesh path to the same tolerances).
"""
from __future__ import annotations

import functools
from typing import List, Sequence

import torch
import torch.distributed as dist

from ..slam.gaussian_map import PARAM_KEYS
from .mesh import mesh_size

__all__ = ["ViewShards", "make_parallel_optimize", "make_parallel_gba_batch",
           "make_parallel_pose_refine"]


class ViewShards:
    """This rank's contiguous share of a view axis over the mesh's
    ``axis`` group, and the collectives of the view-parallel programs."""

    def __init__(self, mesh, axis: str = "mv"):
        self.group = mesh.get_group(axis)
        self.n = mesh_size(mesh, axis)
        self.rank = mesh.get_local_rank(axis)

    def sizes(self, n_rows: int) -> List[int]:
        """Rows per rank of an axis of ``n_rows`` (``tensor_split``)."""
        return [n_rows // self.n + (r < n_rows % self.n)
                for r in range(self.n)]

    def rows(self, sizes: Sequence[int]) -> slice:
        start = sum(sizes[:self.rank])
        return slice(start, start + sizes[self.rank])

    def all_reduce(self, tensors: Sequence[torch.Tensor], op=dist.ReduceOp.SUM
                   ) -> List[torch.Tensor]:
        """One ``all_reduce`` of the tensors flattened into one f32 buffer;
        returns them reduced, in their shapes and dtypes."""
        buf = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(buf, op=op, group=self.group)
        out, o = [], 0
        for t in tensors:
            out.append(buf[o:o + t.numel()].reshape(t.shape).to(t.dtype))
            o += t.numel()
        return out

    def gather_rows(self, rows: torch.Tensor, sizes: Sequence[int]
                    ) -> torch.Tensor:
        """Every rank's (sizes[rank], D) f32 rows, concatenated in rank
        order on every rank (one ``all_gather`` of rows padded to the
        largest share)."""
        pad = torch.zeros((max(sizes),) + tuple(rows.shape[1:]),
                          dtype=torch.float32, device=rows.device)
        pad[:rows.shape[0]] = rows
        parts = [torch.empty_like(pad) for _ in range(self.n)]
        dist.all_gather(parts, pad, group=self.group)
        return torch.cat([p[:s] for p, s in zip(parts, sizes)])

    # ------------------------------------------------------------------
    def window_value_and_grad(self, loss_raw, args, leaves, weights):
        """(window loss, gradients of ``leaves``) of the sequential
        ``_window_loss`` from this rank's views: the rank's raw loss
        (``loss_raw(*args)``, skipped without views) and gradients, the
        Gaussian gradients (the first five leaves), the loss sum and the
        weight sum summed over the ranks in one ``all_reduce``, every
        gradient divided by the global weight sum."""
        if weights.numel():
            tot = loss_raw(*args)
            grads = list(torch.autograd.grad(tot, leaves))
            tot = tot.detach()
        else:
            tot = torch.zeros((), device=weights.device)
            grads = [torch.zeros_like(x) for x in leaves]
        n_p = len(PARAM_KEYS)
        red = self.all_reduce(grads[:n_p] + [tot, weights.sum()])
        wsum = torch.clamp(red[-1], min=1.0)
        return red[n_p] / wsum, [g / wsum for g in red[:n_p] + grads[n_p:]]

    def share_camera_rows(self, cams, idx_all: torch.Tensor,
                          sizes: Sequence[int]):
        """Each rank's rows of ``idx_all`` (pose, exposure) written into
        every rank's camera buffer."""
        mine = idx_all[self.rows(sizes)]
        rows = torch.cat([cams.w2c[mine].flatten(1),
                          cams.exposure_a[mine].flatten(1),
                          cams.exposure_b[mine]], 1)
        allr = self.gather_rows(rows, sizes)
        cams.w2c[idx_all] = allr[:, :16].reshape(-1, 4, 4)
        cams.exposure_a[idx_all] = allr[:, 16:25].reshape(-1, 3, 3)
        cams.exposure_b[idx_all] = allr[:, 25:28]


def make_parallel_optimize(backend, mesh, axis: str = "mv"):
    """Drop-in for ``backend.optimization_steps`` that shards the window's
    views over ``mesh``'s ``axis`` (see the module docstring)."""
    from ..slam.mapping import MappingBackend
    return functools.partial(MappingBackend.optimization_steps, backend,
                             shards=ViewShards(mesh, axis))


def make_parallel_gba_batch(backend, mesh, axis: str = "mv"):
    """Drop-in for ``backend._gba_batch``: each rank renders its share of
    the batch's views (and their cached ``bins`` / gt normals); the
    Gaussian-space sums ride one ``all_reduce`` (SUM) and the radii one
    (MAX); the per-view losses, pose / exposure gradients and w2c rows are
    gathered. The batch size is a multiple of the ranks
    (``MappingBackend.gba_plan``)."""
    from ..slam.mapping import MappingBackend
    sh = ViewShards(mesh, axis)
    seq = functools.partial(MappingBackend._gba_batch, backend)

    def gba_batch(params, alive, w2c_all, expa_all, expb_all, vi_batch,
                  gdns, bins=None):
        sizes = sh.sizes(int(vi_batch.shape[0]))
        r = sh.rows(sizes)
        if sizes[sh.rank]:
            losses, gp, ga_c, den_c, mr_c, gpes, w2cs = seq(
                params, alive, w2c_all, expa_all, expb_all, vi_batch[r],
                gdns[r], None if bins is None else tuple(b[r] for b in bins))
        else:
            dev, n = params["xyz"].device, params["xyz"].shape[0]
            losses = torch.zeros(0, device=dev)
            gp = {k: torch.zeros_like(v) for k, v in params.items()}
            ga_c = torch.zeros(n, device=dev)
            den_c = torch.zeros(n, device=dev)
            mr_c = torch.zeros(n, device=dev)
            gpes = {k: torch.zeros((0,) + s, device=dev) for k, s in
                    (("t", (3,)), ("r", (3,)), ("a", (3, 3)), ("b", (3,)))}
            w2cs = torch.zeros(0, 4, 4, device=dev)
        red = sh.all_reduce([gp[k] for k in PARAM_KEYS] + [ga_c, den_c])
        gp = dict(zip(PARAM_KEYS, red[:len(PARAM_KEYS)]))
        ga_c, den_c = red[len(PARAM_KEYS):]
        (mr_c,) = sh.all_reduce([mr_c], op=dist.ReduceOp.MAX)
        allr = sh.gather_rows(torch.cat(
            [losses[:, None]] + [gpes[k].flatten(1) for k in "tra"]
            + [gpes["b"], w2cs.flatten(1)], 1), sizes)
        cols = torch.split(allr, [1, 3, 3, 9, 3, 16], 1)
        gpes = {"t": cols[1], "r": cols[2], "a": cols[3].reshape(-1, 3, 3),
                "b": cols[4]}
        return (cols[0][:, 0], gp, ga_c, den_c, mr_c, gpes,
                cols[5].reshape(-1, 4, 4))

    return gba_batch


def make_parallel_pose_refine(backend, mesh, axis: str = "mv"):
    """Drop-in for ``backend.pose_refine_multi``: each rank refines its
    share of the views (independent problems: no collective inside the
    iterations), then the refined poses, scaled depths, pointmaps and
    validity masks are gathered; every rank's camera buffer gets every
    row and every rank returns the whole (pointmaps, valids)."""
    from ..slam.mapping import MappingBackend
    sh = ViewShards(mesh, axis)
    seq = functools.partial(MappingBackend.pose_refine_multi, backend)

    def pose_refine_multi(idxs):
        idxs = [int(i) for i in idxs]
        cfg, cams, dev = backend.cfg, backend.cams, backend.device
        H, W, ds = cfg.height, cfg.width, cfg.downsample
        hd, wd = -(-H // ds), -(-W // ds)
        sizes = sh.sizes(len(idxs))
        mine = idxs[sh.rows(sizes)]
        if mine:
            pms, vals = seq(mine)
        else:
            pms = torch.zeros(0, hd, wd, 3, device=dev)
            vals = torch.zeros(0, hd, wd, dtype=torch.bool, device=dev)
        ki = torch.as_tensor(mine, dtype=torch.long, device=dev)
        allr = sh.gather_rows(torch.cat(
            [cams.w2c[ki].flatten(1), cams.depth[ki].float().flatten(1),
             pms.flatten(1), vals.float().flatten(1)], 1), sizes)
        w2c, depth, pms, vals = torch.split(
            allr, [16, H * W, hd * wd * 3, hd * wd], 1)
        kall = torch.as_tensor(idxs, dtype=torch.long, device=dev)
        cams.w2c[kall] = w2c.reshape(-1, 4, 4)
        cams.depth[kall] = depth.reshape(-1, H, W).to(cams.depth.dtype)
        return pms.reshape(-1, hd, wd, 3), vals.reshape(-1, hd, wd) > 0.5

    return pose_refine_multi
