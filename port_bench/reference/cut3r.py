"""CUT3R of the benchmark's reference: a frozen float32 copy of the port's
CUT3R forward (Wang et al., "Continuous 3D Perception Model with
Persistent State", CVPR 2025, arXiv:2501.12387; the released
``cut3r_512_dpt_4_64`` model): a ViT-L/16 image encoder with 2D RoPE, the
recurrent decoder that interleaves 768 state tokens with each view's
tokens, the pose memory, and the DPT self / cross / rgb heads with the
pose MLP. Module and parameter names are the port's (and upstream's), so
one state_dict loads into both.

Plain PyTorch: every matrix product and convolution in float32 (callers
turn TF32 off, ``full_f32``), the attention an explicit softmax. It
imports nothing of the program.

``use_fp8(model)`` is the control's knob: every ``Linear`` and the patch
embedding round their inputs and weights to float8 e4m3 (per-tensor
scale to its largest finite value) before the float32 product, the
precision below the program's bfloat16.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["CUT3RConfig", "CUT3R", "use_fp8", "full_f32",
           "HEAD_OUTPUTS"]

HEAD_OUTPUTS = ("self", "cross", "rgb", "pose")
FP8_MAX = 448.0   # the largest finite float8 e4m3fn value


@contextlib.contextmanager
def full_f32():
    """Float32 products and convolutions at float32 accuracy (no TF32)
    inside the block; the caller's settings restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3fn with a per-tensor scale, back in
    float32; the gradient passes to ``x`` unrounded (the products' saved
    operands stay rounded)."""
    x = x.float()
    with torch.no_grad():
        scale = FP8_MAX / torch.clamp(x.abs().amax(), min=1e-30)
        r = (x * scale).to(torch.float8_e4m3fn).float() / scale
    return x + (r - x).detach()


@dataclasses.dataclass(frozen=True)
class CUT3RConfig:
    enc_embed_dim: int = 1024
    enc_depth: int = 24
    enc_num_heads: int = 16
    dec_embed_dim: int = 768
    dec_depth: int = 12
    dec_num_heads: int = 12
    state_size: int = 768
    state_dec_num_heads: int = 16
    local_mem_size: int = 256
    ray_enc_depth: int = 2
    patch_size: int = 16
    mlp_ratio: float = 4.0
    rope_base: float = 100.0
    has_rgb: bool = True


# ---------------------------------------------------------------------------
# RoPE 2D
# ---------------------------------------------------------------------------

def _rotate_half(x):
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], -1)


def apply_rope2d(tokens, positions, base=100.0):
    """tokens (B, H, N, D); positions (B, N, 2) (y, x): the first half of
    D rotates by y, the second by x, frequencies 1 / base^(2i/(D/2))."""
    dtype = tokens.dtype
    half = tokens.shape[-1] // 2
    t = tokens.float()
    quarter = half // 2
    inv_freq = 1.0 / (base ** (torch.arange(0, quarter, dtype=torch.float32,
                                            device=t.device) * 2.0 / half))
    ang = positions.float()[..., None] * inv_freq
    ang = torch.cat([ang, ang], -1)
    cos, sin = torch.cos(ang), torch.sin(ang)            # (B, N, 2, half)
    ty, tx = t[..., :half], t[..., half:]
    cy, sy = cos[..., 0, :][:, None], sin[..., 0, :][:, None]
    cx, sx = cos[..., 1, :][:, None], sin[..., 1, :][:, None]
    ty = ty * cy + _rotate_half(ty) * sy
    tx = tx * cx + _rotate_half(tx) * sx
    return torch.cat([ty, tx], -1).to(dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class Linear(nn.Linear):
    fp8 = False

    def forward(self, x):
        if self.fp8:
            return F.linear(round_fp8(x), round_fp8(self.weight), self.bias)
        return F.linear(x.float(), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def __init__(self, dim):
        super().__init__(dim, eps=1e-6)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps)


class Mlp(nn.Module):
    def __init__(self, in_dim, hidden_dim, out_dim=None):
        super().__init__()
        self.fc1 = Linear(in_dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, out_dim or in_dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def _attend(q, k, v, scale):
    s = (q @ k.transpose(-2, -1)) * scale
    return torch.softmax(s, -1) @ v


class Attention(nn.Module):
    def __init__(self, dim, num_heads, use_rope=False, rope_base=100.0):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.use_rope, self.rope_base = use_rope, rope_base
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x, xpos):
        B, N, _ = x.shape
        H, D = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        if self.use_rope and xpos is not None:
            q = apply_rope2d(q, xpos, self.rope_base)
            k = apply_rope2d(k, xpos, self.rope_base)
        out = _attend(q, k, v, D ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, N, H * D))


class CrossAttention(nn.Module):
    def __init__(self, dim, num_heads, use_rope=False, rope_base=100.0):
        super().__init__()
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.use_rope, self.rope_base = use_rope, rope_base
        self.projq = Linear(dim, dim)
        self.projk = Linear(dim, dim)
        self.projv = Linear(dim, dim)
        self.proj = Linear(dim, dim)

    def forward(self, query, key, value, qpos, kpos):
        B, Nq, _ = query.shape
        Nk = key.shape[1]
        H, D = self.num_heads, self.head_dim
        if Nk == 1:      # one key: the softmax is 1, every query reads it
            return self.proj(self.projv(value).expand(B, Nq, H * D))
        q = self.projq(query).reshape(B, Nq, H, D).transpose(1, 2)
        k = self.projk(key).reshape(B, Nk, H, D).transpose(1, 2)
        v = self.projv(value).reshape(B, Nk, H, D).transpose(1, 2)
        if self.use_rope:
            if qpos is not None:
                q = apply_rope2d(q, qpos, self.rope_base)
            if kpos is not None:
                k = apply_rope2d(k, kpos, self.rope_base)
        out = _attend(q, k, v, D ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(B, Nq, H * D))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_rope, rope_base)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, xpos):
        x = x + self.attn(self.norm1(x), xpos)
        return x + self.mlp(self.norm2(x))


class DecoderBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, use_rope, rope_base)
        self.norm_y = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, use_rope, rope_base)
        self.norm3 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, y, xpos, ypos):
        x = x + self.attn(self.norm1(x), xpos)
        y_ = self.norm_y(y)
        x = x + self.cross_attn(self.norm2(x), y_, y_, xpos, ypos)
        return x + self.mlp(self.norm3(x))


class ModLN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.mlp = nn.Sequential(nn.SiLU(), Linear(dim, 2 * dim))

    def forward(self, x, mod):
        shift, scale = self.mlp(mod).chunk(2, dim=-1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class ConditionModulationBlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=4.0, use_rope=False,
                 rope_base=100.0):
        super().__init__()
        self.norm1 = ModLN(dim)
        self.attn = Attention(dim, num_heads, use_rope, rope_base)
        self.norm2 = ModLN(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, mod, xpos):
        x = x + self.attn(self.norm1(x, mod), xpos)
        return x + self.mlp(self.norm2(x, mod))


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim, patch_size=16, in_chans=3):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, patch_size)
        self.fp8 = False

    def forward(self, img):
        B, H, W, _ = img.shape
        p = self.patch_size
        x, w = img.permute(0, 3, 1, 2).float(), self.proj.weight
        if self.fp8:
            x, w = round_fp8(x), round_fp8(w)
        x = F.conv2d(x, w, self.proj.bias, stride=p)
        gy, gx = torch.meshgrid(torch.arange(H // p, device=img.device),
                                torch.arange(W // p, device=img.device),
                                indexing="ij")
        pos = torch.stack([gy, gx], -1).reshape(1, -1, 2).expand(B, -1, 2)
        return x.flatten(2).transpose(1, 2), pos


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------

def _resize(x, h, w):
    if x.shape[-2:] == (h, w):
        return x
    return F.interpolate(x, size=(h, w), mode="bilinear", align_corners=True)


class ResidualConvUnit(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features, with_res=True):
        super().__init__()
        if with_res:
            self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, res=None):
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        x = _resize(x, 2 * x.shape[-2], 2 * x.shape[-1])
        return self.out_conv(x)


class _Param(nn.Module):
    """A parameter-free slot of the head's ``nn.ModuleList``."""

    def forward(self, x):
        return x


class DPTAdapter(nn.Module):
    def __init__(self, in_dims, num_channels, layer_dims=(96, 192, 384, 768),
                 feature_dim=256, last_dim=128, patch_size=16):
        super().__init__()
        self.patch_size = patch_size
        ld = layer_dims
        self.act_postprocess = nn.ModuleList([
            nn.Sequential(nn.Conv2d(in_dims[0], ld[0], 1),
                          nn.ConvTranspose2d(ld[0], ld[0], 4, stride=4)),
            nn.Sequential(nn.Conv2d(in_dims[1], ld[1], 1),
                          nn.ConvTranspose2d(ld[1], ld[1], 2, stride=2)),
            nn.Sequential(nn.Conv2d(in_dims[2], ld[2], 1)),
            nn.Sequential(nn.Conv2d(in_dims[3], ld[3], 1),
                          nn.Conv2d(ld[3], ld[3], 3, stride=2, padding=1)),
        ])
        self.scratch = nn.Module()
        for k in range(4):
            setattr(self.scratch, f"layer{k + 1}_rn",
                    nn.Conv2d(ld[k], feature_dim, 3, padding=1, bias=False))
        for k in range(1, 5):
            setattr(self.scratch, f"refinenet{k}",
                    FeatureFusionBlock(feature_dim, with_res=k < 4))
        self.head = nn.ModuleList([
            nn.Conv2d(feature_dim, feature_dim // 2, 3, padding=1), _Param(),
            nn.Conv2d(feature_dim // 2, last_dim, 3, padding=1), _Param(),
            nn.Conv2d(last_dim, num_channels, 1)])

    def forward(self, tokens, img_h, img_w):
        nh, nw = img_h // self.patch_size, img_w // self.patch_size
        feats = [t.float().transpose(1, 2).reshape(t.shape[0], -1, nh, nw)
                 for t in tokens]
        layers = [act(f) for act, f in zip(self.act_postprocess, feats)]
        s = self.scratch
        rn = [getattr(s, f"layer{k + 1}_rn")(x) for k, x in enumerate(layers)]
        p = s.refinenet4(rn[3])
        p = p[..., : rn[2].shape[-2], : rn[2].shape[-1]]
        p = s.refinenet3(p, rn[2])
        p = p[..., : rn[1].shape[-2], : rn[1].shape[-1]]
        p = s.refinenet2(p, rn[1])
        p = p[..., : rn[0].shape[-2], : rn[0].shape[-1]]
        p = s.refinenet1(p, rn[0])
        h = _resize(self.head[0](p), img_h, img_w)
        h = F.relu(self.head[2](h))
        return self.head[4](h).permute(0, 2, 3, 1)


def reg_dense_depth(xyz):
    d = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    return xyz / torch.clamp(d, min=1e-8) * torch.expm1(torch.clamp(d,
                                                                    max=60.0))


def postprocess_pose(out):
    """(t, quaternion wxyz): t * expm1(|t|) / |t|, the quaternion unit with
    w >= 0."""
    trans, quats = out[..., 0:3], out[..., 3:7]
    d = torch.linalg.norm(trans, dim=-1, keepdim=True)
    trans = trans * (torch.expm1(torch.clamp(d, max=60.0))
                     / torch.clamp(d, min=1e-8))
    quats = quats / torch.clamp(torch.linalg.norm(quats, dim=-1,
                                                  keepdim=True), min=1e-12)
    quats = torch.where(quats[..., 0:1] < 0, -quats, quats)
    return torch.cat([trans, quats], -1)


class PoseDecoder(nn.Module):
    def __init__(self, hidden_dim):
        super().__init__()
        self.mlp = Mlp(hidden_dim, hidden_dim * 4, out_dim=7)

    def forward(self, x):
        return self.mlp(x)


class DPTPts3dPose(nn.Module):
    def __init__(self, enc_dim, dec_embed_dim, dec_num_heads, has_rgb=True,
                 rope_base=100.0):
        super().__init__()
        dims = (enc_dim, dec_embed_dim, dec_embed_dim, dec_embed_dim)
        self.has_rgb = has_rgb
        self.pose_head = PoseDecoder(dec_embed_dim)
        self.dpt_self = DPTAdapter(dims, 4)
        self.final_transform = nn.ModuleList([
            ConditionModulationBlock(dec_embed_dim, dec_num_heads,
                                     use_rope=True, rope_base=rope_base)
            for _ in range(2)])
        self.dpt_cross = DPTAdapter(dims, 4)
        if has_rgb:
            self.dpt_rgb = DPTAdapter(dims, 3)

    def forward(self, hook_tokens, img_h, img_w, pos, outputs=HEAD_OUTPUTS):
        pose_token = hook_tokens[-1][:, 0].float()
        token = hook_tokens[-1][:, 1:].float()
        x_self = [t.float() for t in hook_tokens[:-1]] + [token]
        out = {}
        if "pose" in outputs:
            out["camera_pose"] = postprocess_pose(self.pose_head(pose_token))
        if "self" in outputs:
            so = self.dpt_self(x_self, img_h, img_w)
            out["pts3d_in_self_view"] = reg_dense_depth(so[..., :3])
            out["conf_self"] = 1.0 + torch.exp(so[..., 3])
        if "cross" in outputs:
            tc = token
            for blk in self.final_transform:
                tc = blk(tc, pose_token, pos)
            co = self.dpt_cross(x_self[:-1] + [tc], img_h, img_w)
            out["pts3d_in_other_view"] = reg_dense_depth(co[..., :3])
            out["conf"] = 1.0 + torch.exp(co[..., 3])
        if self.has_rgb and "rgb" in outputs:
            eps = 1e-6
            rgb = torch.sigmoid(self.dpt_rgb(x_self, img_h, img_w)) \
                * (1 - 2 * eps) + eps
            out["rgb"] = (rgb - 0.5) * 2
        return out


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class LocalMemory(nn.Module):
    """Pose key / value memory."""

    def __init__(self, size, k_dim, v_dim, num_heads, depth=2):
        super().__init__()
        self.size, self.v_dim = size, v_dim
        self.proj_q = Linear(k_dim, v_dim)
        self.masked_token = nn.Parameter(torch.zeros(1, 1, v_dim))
        self.mem = nn.Parameter(torch.zeros(1, size, 2 * v_dim))
        self.write_blocks = nn.ModuleList([
            DecoderBlock(2 * v_dim, num_heads) for _ in range(depth)])
        self.read_blocks = nn.ModuleList([
            DecoderBlock(2 * v_dim, num_heads) for _ in range(depth)])

    def update_mem(self, mem, feat_k, feat_v):
        feat = torch.cat([self.proj_q(feat_k), feat_v], -1)
        for blk in self.write_blocks:
            mem = blk(mem, feat, None, None)
        return mem

    def inquire(self, query, mem):
        x = self.proj_q(query)
        x = torch.cat([x, self.masked_token.expand(x.shape[0], 1,
                                                   self.v_dim)], -1)
        for blk in self.read_blocks:
            x = blk(x, mem, None, None)
        return x[..., -self.v_dim:]


def _state_positions(state_size, batch, device):
    width = int(state_size ** 0.5)
    width = width + 1 if width % 2 == 1 else width
    idx = torch.arange(state_size, device=device)
    pos = torch.stack([torch.div(idx, width, rounding_mode="floor"),
                       idx % width], -1)[None]
    return pos.expand(batch, state_size, 2)


class CUT3R(nn.Module):
    def __init__(self, cfg: CUT3RConfig = CUT3RConfig()):
        super().__init__()
        self.cfg = c = cfg
        self.patch_embed = PatchEmbed(c.enc_embed_dim, c.patch_size)
        self.enc_blocks = nn.ModuleList([
            Block(c.enc_embed_dim, c.enc_num_heads, c.mlp_ratio, True,
                  c.rope_base) for _ in range(c.enc_depth)])
        self.enc_norm = LayerNorm(c.enc_embed_dim)
        self.decoder_embed = Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.decoder_embed_state = Linear(c.enc_embed_dim, c.dec_embed_dim)
        self.dec_blocks = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.dec_num_heads, c.mlp_ratio, True,
                         c.rope_base) for _ in range(c.dec_depth)])
        self.dec_blocks_state = nn.ModuleList([
            DecoderBlock(c.dec_embed_dim, c.state_dec_num_heads, c.mlp_ratio,
                         True, c.rope_base) for _ in range(c.dec_depth)])
        self.dec_norm = LayerNorm(c.dec_embed_dim)
        self.dec_norm_state = LayerNorm(c.dec_embed_dim)
        self.register_tokens = nn.Embedding(c.state_size, c.enc_embed_dim)
        self.pose_token = nn.Parameter(torch.zeros(1, 1, c.dec_embed_dim))
        self.pose_retriever = LocalMemory(c.local_mem_size, c.enc_embed_dim,
                                          c.dec_embed_dim, c.dec_num_heads)
        self.downstream_head = DPTPts3dPose(
            c.enc_embed_dim, c.dec_embed_dim, c.dec_num_heads,
            has_rgb=c.has_rgb, rope_base=c.rope_base)
        # the ray-map encoder (unused by the forward; its weights load)
        self.patch_embed_ray_map = PatchEmbed(c.enc_embed_dim, c.patch_size,
                                              in_chans=6)
        self.enc_blocks_ray_map = nn.ModuleList([
            Block(c.enc_embed_dim, 16, 4.0, True, c.rope_base)
            for _ in range(c.ray_enc_depth)])
        self.enc_norm_ray_map = LayerNorm(c.enc_embed_dim)
        self.masked_img_token = nn.Parameter(torch.zeros(1, c.enc_embed_dim))
        self.masked_ray_map_token = nn.Parameter(
            torch.zeros(1, c.enc_embed_dim))

    def encode_image(self, img):
        """img (B, H, W, 3) in [-1, 1] -> tokens (B, N, D), positions."""
        x, pos = self.patch_embed(img)
        for blk in self.enc_blocks:
            x = blk(x, pos)
        return self.enc_norm(x), pos

    def _decode_step(self, state_feat, state_pos, mem, feat_i, pos_i,
                     is_first):
        c = self.cfg
        B = feat_i.shape[0]
        global_feat = feat_i.mean(1, keepdim=True)
        if is_first:
            pose_feat = self.pose_token.expand(B, 1, c.dec_embed_dim)
        else:
            pose_feat = self.pose_retriever.inquire(global_feat, mem)
        pose_pos = -torch.ones(B, 1, 2, dtype=pos_i.dtype,
                               device=pos_i.device)
        f_img = torch.cat([pose_feat, self.decoder_embed(feat_i)], 1)
        pos_img = torch.cat([pose_pos, pos_i], 1)
        hooks = {0: feat_i}
        f_state = state_feat
        for layer, (blk_state, blk_img) in enumerate(
                zip(self.dec_blocks_state, self.dec_blocks), start=1):
            f_state_new = blk_state(f_state, f_img, state_pos, pos_img)
            f_img = blk_img(f_img, f_state, pos_img, state_pos)
            f_state = f_state_new
            if layer in (c.dec_depth * 2 // 4, c.dec_depth * 3 // 4):
                hooks[layer] = f_img[:, 1:]
        f_state = self.dec_norm_state(f_state)
        f_img = self.dec_norm(f_img)
        mem = self.pose_retriever.update_mem(mem, global_feat, f_img[:, 0:1])
        return f_state, mem, [hooks[0], hooks[c.dec_depth * 2 // 4],
                              hooks[c.dec_depth * 3 // 4], f_img]

    def decode_views(self, feat, pos, H, W, head_outputs=HEAD_OUTPUTS):
        """The recurrence from a fresh state over V views of encoder
        tokens feat (V, B, N, D), then the heads: dict of (V, B, ...)."""
        c = self.cfg
        V, B, N = feat.shape[:3]
        reg = self.register_tokens.weight
        state = self.decoder_embed_state(
            reg[None].expand(B, c.state_size, c.enc_embed_dim))
        state_pos = _state_positions(c.state_size, B, feat.device)
        mem = self.pose_retriever.mem.expand(B, c.local_mem_size,
                                             2 * c.dec_embed_dim)
        hooks = []
        for v in range(V):
            state, mem, hl = self._decode_step(state, state_pos, mem, feat[v],
                                               pos[v], v == 0)
            hooks.append(hl)
        stacked = [torch.cat([h[k] for h in hooks], 0) for k in range(4)]
        out = self.downstream_head(stacked, H, W, pos.reshape(V * B, N, 2),
                                   outputs=head_outputs)
        return {k: x.reshape((V, B) + x.shape[1:]) for k, x in out.items()}

    def forward(self, imgs, head_outputs=HEAD_OUTPUTS):
        """imgs (V, B, H, W, 3) in [-1, 1] -> dict of (V, B, ...)."""
        V, B, H, W, _ = imgs.shape
        feat, pos = self.encode_image(imgs.reshape(V * B, H, W, 3))
        N = feat.shape[1]
        return self.decode_views(feat.reshape(V, B, N, -1),
                                 pos.reshape(V, B, N, 2), H, W, head_outputs)


def use_fp8(model: nn.Module) -> nn.Module:
    """The control: every Linear and patch embedding of ``model`` through
    float8 e4m3 (see the module docstring)."""
    for m in model.modules():
        if isinstance(m, (Linear, PatchEmbed)):
            m.fp8 = True
    return model


def normalize_images(img_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] HWC -> [-1, 1]."""
    return (img_u8.float() / 255.0 - 0.5) / 0.5


def quat_wxyz_to_c2w(pose: torch.Tensor) -> torch.Tensor:
    """(..., 7) [t, q wxyz] -> (..., 4, 4) camera-to-world."""
    w, x, y, z = pose[..., 3:7].unbind(-1)
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(pose.shape[:-1] + (3, 3))
    out = torch.zeros(pose.shape[:-1] + (4, 4), dtype=pose.dtype,
                      device=pose.device)
    out[..., :3, :3] = R
    out[..., :3, 3] = pose[..., :3]
    out[..., 3, 3] = 1.0
    return out

