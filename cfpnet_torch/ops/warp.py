"""Differentiable view synthesis for the self-supervised variant.

Port of ``cfpnet_tpu/ops/warp.py`` (``axis_angle_to_matrix``,
``pose_to_transform``, ``backproject``, ``project``, ``grid_sample``,
``warp_frame``, ``ssim``, ``photometric_loss``, ``smoothness_loss``):
backproject the target frame's depth, move the points by a 6DoF pose,
project them into the source frame and sample it bilinearly
(monodepth2-style). Tensors are NHWC, as in the JAX package.

The JAX module is plain XLA (no Pallas kernel), and so is this one: plain
PyTorch, the same operations in the same order. Two points keep the
gradients equal to JAX's:

- ``clip`` is ``jnp.clip``'s ``maximum``/``minimum`` pair, which splits the
  gradient in half where the value equals a bound (an integer sampling
  coordinate makes ``x - floor(x)`` equal 0); ``torch.clamp`` would pass
  all of it;
- ``absolute`` has ``jnp.abs``'s gradient, 1 at 0 (``torch.abs`` gives 0
  there: two equal neighbours in the smoothness term, a depth clipped at
  ``min_depth`` on both sides of an edge);
- ``grid_sample`` is the JAX gather (``torch.gather`` on the flat
  [B, H*W, C] image), not ``F.grid_sample``, whose coordinate
  normalisation rounds differently.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def clip(x: torch.Tensor, lo: Optional[float], hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``maximum`` then ``minimum``, half the
    gradient to each side of a tie. The bounds are filled on x's device
    (no copy from the host)."""
    if lo is not None:
        x = torch.maximum(torch.full((), lo, dtype=x.dtype, device=x.device), x)
    if hi is not None:
        x = torch.minimum(torch.full((), hi, dtype=x.dtype, device=x.device), x)
    return x


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: |x|, with the gradient 1 at x = 0 (JAX's
    ``select(x >= 0, g, -g)``)."""
    return torch.where(x >= 0, x, -x)


def axis_angle_to_matrix(vec: torch.Tensor) -> torch.Tensor:
    """[..., 3] axis-angle -> [..., 3, 3] rotation (Rodrigues).

    Smoothed norm, as the JAX function: the pose head starts at zero, where
    ``torch.linalg.norm`` has a NaN gradient."""
    angle = torch.sqrt(torch.sum(vec * vec, dim=-1, keepdim=True) + 1e-14)
    axis = vec / (angle + 1e-7)
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    x, y, z = axis[..., 0:1], axis[..., 1:2], axis[..., 2:3]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.cat([zero, -z, y], -1),
                     torch.cat([z, zero, -x], -1),
                     torch.cat([-y, x, zero], -1)], dim=-2)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device)
    return eye + sa * K + (1.0 - ca) * (K @ K)


def pose_to_transform(axisangle: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """([B,3], [B,3]) -> [B,4,4] SE(3)."""
    B = axisangle.shape[0]
    R = axis_angle_to_matrix(axisangle)
    top = torch.cat([R, translation[:, :, None]], dim=-1)
    bottom = torch.zeros((B, 1, 4), dtype=axisangle.dtype, device=axisangle.device)
    bottom[:, :, 3] = 1.0
    return torch.cat([top, bottom], dim=1)


def backproject(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """depth [B,H,W,1] + K_inv [B,3,3] -> camera points [B,H,W,3]."""
    _, H, W, _ = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # [H,W,3]
    rays = torch.einsum("bij,hwj->bhwi", K_inv, pix)
    return rays * depth


def project(points: torch.Tensor, K: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Camera points [B,H,W,3] moved by pose T [B,4,4] -> pixel coordinates
    [B,H,W,2]."""
    R, t = T[:, :3, :3], T[:, :3, 3]
    p = torch.einsum("bij,bhwj->bhwi", R, points) + t[:, None, None, :]
    p = torch.einsum("bij,bhwj->bhwi", K, p)
    z = clip(p[..., 2:3], 1e-3)
    return p[..., :2] / z


def grid_sample(img: torch.Tensor, coords: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bilinear sample of img [B,H,W,C] at pixel coordinates [B,H,W,2]
    (x, y). Returns (sampled [B,H,W,C], in-bounds mask [B,H,W,1] in img's
    dtype); the mask is taken from the unclipped coordinates."""
    B, H, W, C = img.shape
    x, y = coords[..., 0], coords[..., 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)

    x0 = clip(torch.floor(x), 0, W - 1)
    y0 = clip(torch.floor(y), 0, H - 1)
    x1 = clip(x0 + 1, 0, W - 1)
    y1 = clip(y0 + 1, 0, H - 1)
    wx = clip(x - x0, 0.0, 1.0)[..., None]
    wy = clip(y - y0, 0.0, 1.0)[..., None]

    flat = img.reshape(B, H * W, C)

    def gather(yy, xx):
        # a NaN coordinate (a NaN pose) casts to an index outside the image:
        # clamped into it, its sample is NaN all the same through its NaN
        # weights, as JAX's gather fills NaN there
        idx = (yy * W + xx).to(torch.int64).clamp(0, H * W - 1)
        idx = idx.reshape(B, H * W, 1).expand(B, H * W, C)
        return torch.gather(flat, 1, idx).reshape(B, H, W, C)

    v00 = gather(y0, x0)
    v01 = gather(y0, x1)
    v10 = gather(y1, x0)
    v11 = gather(y1, x1)
    out = (v00 * (1 - wx) * (1 - wy)
           + v01 * wx * (1 - wy)
           + v10 * (1 - wx) * wy
           + v11 * wx * wy)
    return out, valid[..., None].to(img.dtype)


def warp_frame(src: torch.Tensor, depth: torch.Tensor, K: torch.Tensor, K_inv: torch.Tensor,
               T: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The target frame synthesized from ``src`` [B,H,W,C] through the
    target's depth [B,H,W,1], intrinsics K, K_inv [B,3,3] and the
    target-to-source pose T [B,4,4]. Returns (warped, valid mask)."""
    return grid_sample(src, project(backproject(depth, K_inv), K, T))


def _pool3(v: torch.Tensor) -> torch.Tensor:
    """3x3 mean over an NCHW tensor padded by reflection (the edge row not
    repeated: numpy's ``mode="reflect"``), summed in the JAX order."""
    H, W = v.shape[-2], v.shape[-1]
    v = F.pad(v, (1, 1, 1, 1), mode="reflect")
    out = 0.0
    for dy in range(3):
        for dx in range(3):
            out = out + v[:, :, dy:dy + H, dx:dx + W]
    return out / 9.0


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """3x3 mean-pooled SSIM dissimilarity (monodepth2), NHWC -> per pixel
    and channel, in [0, 1]."""
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)  # F.pad reflects NCHW's last two
    mx, my = _pool3(x), _pool3(y)
    sx = _pool3(x * x) - mx * mx
    sy = _pool3(y * y) - my * my
    sxy = _pool3(x * y) - mx * my
    num = (2 * mx * my + c1) * (2 * sxy + c2)
    den = (mx * mx + my * my + c1) * (sx + sy + c2)
    return clip((1.0 - num / den) / 2.0, 0.0, 1.0).permute(0, 2, 3, 1)


def photometric_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.85
                     ) -> torch.Tensor:
    """alpha * SSIM + (1 - alpha) * L1, per pixel [B,H,W,1]."""
    l1 = absolute(pred - target).mean(dim=-1, keepdim=True)
    s = ssim(pred, target).mean(dim=-1, keepdim=True)
    return alpha * s + (1.0 - alpha) * l1


def smoothness_loss(depth: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness of the mean-normalized depth
    (monodepth2)."""
    d = depth / (depth.mean(dim=(1, 2, 3), keepdim=True) + 1e-7)
    dx = absolute(d[:, :, 1:, :] - d[:, :, :-1, :])
    dy = absolute(d[:, 1:, :, :] - d[:, :-1, :, :])
    ix = absolute(img[:, :, 1:, :] - img[:, :, :-1, :]).mean(-1, keepdim=True)
    iy = absolute(img[:, 1:, :, :] - img[:, :-1, :, :]).mean(-1, keepdim=True)
    return (dx * torch.exp(-ix)).mean() + (dy * torch.exp(-iy)).mean()
