"""Gold parity test: flax CUT3R + converter vs the reference torch model.

Instantiates the reference ``ARCroco3DStereo`` (read-only import from
/root/reference — skipped when unavailable) with a tiny config, converts
its state_dict with models/convert.py, and checks our forward reproduces
the torch outputs on random views to float32 tolerance. This validates the
blocks, RoPE, decoder wiring, LocalMemory, DPT heads, postprocess AND the
checkpoint converter in one shot.
"""
import os
import sys

import numpy as np
import pytest
import torch

REF = "/root/reference/src"
pytestmark = [pytest.mark.slow,  # integration tier (VERDICT r4 #9)
              pytest.mark.skipif(not os.path.isdir(REF),
                                reason="reference repo not mounted")]

H, W, V, B = 32, 48, 3, 1


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads for this module's CPU work (under ``pytest -n``
    every worker's default pool spans all cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torch_ref():
    sys.path.insert(0, REF)
    sys.path.insert(0, REF + "/croco")
    import torch
    torch.manual_seed(0)
    from dust3r.model import ARCroco3DStereo, ARCroco3DStereoConfig
    inf = float("inf")
    cfg = ARCroco3DStereoConfig(
        state_size=16, state_pe="2d", pos_embed="RoPE100",
        rgb_head=True, pose_head=True, patch_embed_cls="PatchEmbedDust3R",
        img_size=(H, W), head_type="dpt", output_mode="pts3d+pose",
        depth_mode=("exp", -inf, inf), conf_mode=("exp", 1, inf),
        pose_mode=("exp", -inf, inf),
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        local_mem_size=8, state_dec_num_heads=2,
        landscape_only=False,
    )
    net = ARCroco3DStereo(cfg).eval()

    # The pure-torch RoPE2D fallback does a table lookup that crashes on the
    # pose token's -1 position; the live CUDA kernel (curope/kernels.cu)
    # computes cos/sin directly from the position value. Patch the shared
    # rope instance to the direct computation so the CPU oracle matches the
    # GPU path.
    import types

    def direct_forward(self, tokens, positions):
        D = tokens.size(3) // 2
        inv_freq = 1.0 / (self.base ** (torch.arange(0, D, 2).float() / D))

        def rope1d(tok, pos1d):
            ang = pos1d.float()[..., None] * inv_freq
            ang = torch.cat((ang, ang), dim=-1)
            cos, sin = ang.cos()[:, None], ang.sin()[:, None]
            h = tok.shape[-1] // 2
            rot = torch.cat((-tok[..., h:], tok[..., :h]), dim=-1)
            return tok * cos + rot * sin

        y, x = tokens.chunk(2, dim=-1)
        y = rope1d(y, positions[:, :, 0])
        x = rope1d(x, positions[:, :, 1])
        return torch.cat((y, x), dim=-1)

    net.rope.forward = types.MethodType(direct_forward, net.rope)
    return net


def _torch_views(images):
    import torch
    views = []
    for i in range(images.shape[0]):
        views.append({
            "img": images[i][None],
            "ray_map": torch.full((1, 6, H, W), torch.nan),
            "true_shape": torch.from_numpy(np.int32([H, W]))[None],
            "idx": i,
            "instance": str(i),
            "camera_pose": torch.eye(4)[None],
            "img_mask": torch.tensor(True)[None],
            "ray_mask": torch.tensor(False)[None],
            "update": torch.tensor(True)[None],
            "reset": torch.tensor(False)[None],
        })
    return views


def test_forward_parity(torch_ref):
    import torch
    import jax
    import jax.numpy as jnp
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.models.convert import convert_state_dict

    rng = np.random.default_rng(0)
    imgs_np = rng.uniform(-1, 1, size=(V, 3, H, W)).astype(np.float32)

    with torch.no_grad():
        out_t = torch_ref(_torch_views(torch.from_numpy(imgs_np)))
    ress = out_t.ress

    cfg = CUT3RConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        state_size=16, state_dec_num_heads=2, local_mem_size=8,
        compute_dtype=jnp.float32)
    model = CUT3R(cfg)
    params = convert_state_dict(torch_ref.state_dict())

    imgs_j = jnp.asarray(imgs_np.transpose(0, 2, 3, 1))[:, None]  # (V,B,H,W,3)
    out_j = jax.jit(model.apply)(params, imgs_j)

    for v in range(V):
        for t_key, j_key in [
            ("pts3d_in_self_view", "pts3d_in_self_view"),
            ("conf_self", "conf_self"),
            ("pts3d_in_other_view", "pts3d_in_other_view"),
            ("conf", "conf"),
            ("rgb", "rgb"),
        ]:
            ref = ress[v][t_key][0].numpy()
            ours = np.asarray(out_j[j_key][v, 0])
            # measured agreement ~3e-4 abs; slack for f32 reduction-order
            # noise across 14+ sequential blocks (torch CPU vs XLA CPU)
            np.testing.assert_allclose(
                ours, ref, rtol=5e-2, atol=2e-3,
                err_msg=f"view {v} key {t_key}")
        ref_pose = ress[v]["camera_pose"][0].numpy()
        ours_pose = np.asarray(out_j["camera_pose"][v, 0])
        # pose error accumulates through the LocalMemory recurrence
        # (measured 1.8e-3 @ view0 -> 5.2e-3 @ view2)
        np.testing.assert_allclose(ours_pose, ref_pose, atol=2e-2,
                                   err_msg=f"view {v} pose")


def test_encoder_parity(torch_ref):
    """encode_image path alone (used by the motion filter)."""
    import torch
    import jax
    import jax.numpy as jnp
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.models.convert import convert_state_dict

    rng = np.random.default_rng(1)
    img_np = rng.uniform(-1, 1, size=(1, 3, H, W)).astype(np.float32)
    with torch.no_grad():
        (feat_t,), pos_t, _ = torch_ref._encode_image(
            torch.from_numpy(img_np),
            torch.from_numpy(np.int32([[H, W]])))

    cfg = CUT3RConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        state_size=16, state_dec_num_heads=2, local_mem_size=8,
        compute_dtype=jnp.float32)
    model = CUT3R(cfg)
    params = convert_state_dict(torch_ref.state_dict())
    feat_j, pos_j = jax.jit(
        lambda p, x: model.apply(p, x, method=CUT3R.encode_image)
    )(params, jnp.asarray(img_np.transpose(0, 2, 3, 1)))

    np.testing.assert_allclose(np.asarray(pos_j), pos_t.numpy(), atol=0)
    # measured ~3e-4 abs (f32 reduction-order, torch CPU vs XLA CPU)
    np.testing.assert_allclose(np.asarray(feat_j), feat_t.numpy(),
                               rtol=1e-2, atol=1e-3)


def _views_hw(images, h, w):
    import torch
    views = []
    for i in range(images.shape[0]):
        views.append({
            "img": images[i][None],
            "ray_map": torch.full((1, 6, h, w), torch.nan),
            "true_shape": torch.from_numpy(np.int32([h, w]))[None],
            "idx": i, "instance": str(i),
            "camera_pose": torch.eye(4)[None],
            "img_mask": torch.tensor(True)[None],
            "ray_mask": torch.tensor(False)[None],
            "update": torch.tensor(True)[None],
            "reset": torch.tensor(False)[None],
        })
    return views


def _patch_rope(net):
    """Direct-computation RoPE (see torch_ref fixture for why)."""
    import types
    import torch

    def direct_forward(self, tokens, positions):
        D = tokens.size(3) // 2
        inv_freq = 1.0 / (self.base ** (torch.arange(0, D, 2).float() / D))

        def rope1d(tok, pos1d):
            ang = pos1d.float()[..., None] * inv_freq
            ang = torch.cat((ang, ang), dim=-1)
            cos, sin = ang.cos()[:, None], ang.sin()[:, None]
            h = tok.shape[-1] // 2
            rot = torch.cat((-tok[..., h:], tok[..., :h]), dim=-1)
            return tok * cos + rot * sin

        y, x = tokens.chunk(2, dim=-1)
        y = rope1d(y, positions[:, :, 0])
        x = rope1d(x, positions[:, :, 1])
        return torch.cat((y, x), dim=-1)

    net.rope.forward = types.MethodType(direct_forward, net.rope)
    return net


def test_linear_head_parity():
    """Converter + forward parity for the linear (224-ckpt) head variant
    (heads/linear_head.py:246-344) — VERDICT r1 #7."""
    import torch
    import jax
    import jax.numpy as jnp
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.models.convert import convert_state_dict

    sys.path.insert(0, REF)
    sys.path.insert(0, REF + "/croco")
    torch.manual_seed(1)
    from dust3r.model import ARCroco3DStereo, ARCroco3DStereoConfig
    inf = float("inf")
    tcfg = ARCroco3DStereoConfig(
        state_size=16, state_pe="2d", pos_embed="RoPE100",
        rgb_head=True, pose_head=True, patch_embed_cls="PatchEmbedDust3R",
        img_size=(H, W), head_type="linear", output_mode="pts3d+pose",
        depth_mode=("exp", -inf, inf), conf_mode=("exp", 1, inf),
        pose_mode=("exp", -inf, inf),
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        local_mem_size=8, state_dec_num_heads=2, landscape_only=False)
    net = _patch_rope(ARCroco3DStereo(tcfg).eval())

    rng = np.random.default_rng(3)
    imgs_np = rng.uniform(-1, 1, size=(V, 3, H, W)).astype(np.float32)
    with torch.no_grad():
        ress = net(_views_hw(torch.from_numpy(imgs_np), H, W)).ress

    cfg = CUT3RConfig(
        enc_embed_dim=64, enc_depth=2, enc_num_heads=2,
        dec_embed_dim=48, dec_depth=4, dec_num_heads=2,
        state_size=16, state_dec_num_heads=2, local_mem_size=8,
        head_type="linear", compute_dtype=jnp.float32)
    model = CUT3R(cfg)
    params = convert_state_dict(net.state_dict())
    imgs_j = jnp.asarray(imgs_np.transpose(0, 2, 3, 1))[:, None]
    out_j = jax.jit(model.apply)(params, imgs_j)

    for v in range(V):
        for key in ["pts3d_in_self_view", "conf_self",
                    "pts3d_in_other_view", "conf", "rgb"]:
            ref = ress[v][key][0].numpy()
            ours = np.asarray(out_j[key][v, 0])
            np.testing.assert_allclose(ours, ref, rtol=5e-2, atol=2e-3,
                                       err_msg=f"view {v} key {key}")
        np.testing.assert_allclose(
            np.asarray(out_j["camera_pose"][v, 0]),
            ress[v]["camera_pose"][0].numpy(), atol=2e-2)


def test_full_scale_converter_parity():
    """Converter parity at the REAL checkpoint sizes (1024/24-enc,
    768/12-dec, 768 state, 256 mem, DPT heads) on a small image so the
    token count stays CPU-friendly — VERDICT r1 #7. Validates every
    name/layout mapping at true tensor shapes."""
    import torch
    import jax
    import jax.numpy as jnp
    from cut3r_slam_tpu.models import CUT3R, CUT3RConfig
    from cut3r_slam_tpu.models.convert import convert_state_dict

    sys.path.insert(0, REF)
    sys.path.insert(0, REF + "/croco")
    torch.manual_seed(2)
    from dust3r.model import ARCroco3DStereo, ARCroco3DStereoConfig
    inf = float("inf")
    h, w, v = 32, 48, 2
    tcfg = ARCroco3DStereoConfig(
        state_size=768, state_pe="2d", pos_embed="RoPE100",
        rgb_head=True, pose_head=True, patch_embed_cls="PatchEmbedDust3R",
        img_size=(h, w), head_type="dpt", output_mode="pts3d+pose",
        depth_mode=("exp", -inf, inf), conf_mode=("exp", 1, inf),
        pose_mode=("exp", -inf, inf),
        enc_embed_dim=1024, enc_depth=24, enc_num_heads=16,
        dec_embed_dim=768, dec_depth=12, dec_num_heads=12,
        local_mem_size=256, state_dec_num_heads=16, landscape_only=False)
    net = _patch_rope(ARCroco3DStereo(tcfg).eval())

    rng = np.random.default_rng(4)
    imgs_np = rng.uniform(-1, 1, size=(v, 3, h, w)).astype(np.float32)
    with torch.no_grad():
        ress = net(_views_hw(torch.from_numpy(imgs_np), h, w)).ress

    model = CUT3R(CUT3RConfig(compute_dtype=jnp.float32))  # full default
    params = convert_state_dict(net.state_dict())
    imgs_j = jnp.asarray(imgs_np.transpose(0, 2, 3, 1))[:, None]
    out_j = jax.jit(model.apply)(params, imgs_j)

    for vi in range(v):
        for key in ["pts3d_in_self_view", "pts3d_in_other_view"]:
            ref = ress[vi][key][0].numpy()
            ours = np.asarray(out_j[key][vi, 0])
            # 36 sequential blocks at f32: reduction-order noise grows;
            # relative agreement is what validates the mapping
            np.testing.assert_allclose(ours, ref, rtol=8e-2, atol=5e-3,
                                       err_msg=f"view {vi} key {key}")
        np.testing.assert_allclose(
            np.asarray(out_j["camera_pose"][vi, 0]),
            ress[vi]["camera_pose"][0].numpy(), atol=3e-2)
