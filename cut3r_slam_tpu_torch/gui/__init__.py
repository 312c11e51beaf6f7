"""Live SLAM viewer (browser-based; port of ``cut3r_slam_tpu/gui``): a
small HTTP server exposes the live SLAM state (Gaussian arena, keyframe
trajectory, loop edges, keyframe images, server-side renders) and a
WebGL2 page draws it in any browser. Pull-based: nothing is copied from
the device unless a client asks."""
from .server import ViewerServer, pack_splats

__all__ = ["ViewerServer", "pack_splats"]
