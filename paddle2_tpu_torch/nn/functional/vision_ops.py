"""``affine_grid`` and ``grid_sample``: the counterpart of
``paddle2_tpu/nn/functional/vision_ops.py``, in the same arithmetic
(not torch's ``F.grid_sample``, whose rules differ):

- ``align_corners`` defaults to True;
- ``affine_grid`` builds its base grid in float32 and returns the
  promotion of float32 and ``theta``'s dtype, as ``jnp.einsum`` does;
- ``grid_sample``'s ``"nearest"`` rounds half to even; ``"bilinear"``
  weighs the four corners by the fractional parts;
- any ``padding_mode`` but ``"zeros"`` clamps each corner's index to the
  image (``"reflection"`` too); ``"zeros"`` clamps and then zeroes the
  corners outside;
- gradients reach ``x`` and ``grid`` (through the weights; the floor of
  a coordinate has none).
"""

import torch

from ...amp.casting import amp_op

__all__ = ["affine_grid", "grid_sample"]


@amp_op("affine_grid")
def _affine_grid(theta, n, h, w, align_corners):
    dev = theta.device
    if align_corners:
        ys = torch.linspace(-1.0, 1.0, h, device=dev)
        xs = torch.linspace(-1.0, 1.0, w, device=dev)
    else:
        ys = (torch.arange(h, device=dev) * 2 + 1) / h - 1
        xs = (torch.arange(w, device=dev) * 2 + 1) / w - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)     # [H, W, 3]
    dt = torch.promote_types(base.dtype, theta.dtype)
    return torch.einsum("hwk,nik->nhwi", base.to(dt), theta.to(dt))


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """``theta`` ``[N, 2, 3]`` -> the sampling grid ``[N, H, W, 2]`` of
    ``out_shape`` ``[N, C, H, W]``."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    n, _, h, w = [int(v) for v in out_shape]
    return _affine_grid(theta, n, h, w, align_corners)


@amp_op("grid_sample")
def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` ``[N, C, H, W]`` at ``grid`` ``[N, Ho, Wo, 2]`` (x, y
    in [-1, 1]) -> ``[N, C, Ho, Wo]``."""
    n, _, h, w = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx = (gx + 1) * (w - 1) / 2
        fy = (gy + 1) * (h - 1) / 2
    else:
        fx = ((gx + 1) * w - 1) / 2
        fy = ((gy + 1) * h - 1) / 2
    batch = torch.arange(n, device=x.device)[:, None, None]

    def pix(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        vals = x[batch, :, yy.clamp(0, h - 1), xx.clamp(0, w - 1)]
        vals = vals.movedim(-1, 1)                          # [N,C,Ho,Wo]
        if padding_mode == "zeros":
            vals = vals * inside[:, None].to(vals.dtype)
        return vals

    if mode == "nearest":
        return pix(torch.round(fy).to(torch.int32),
                   torch.round(fx).to(torch.int32))
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    return (pix(y0, x0) * (1 - wy) * (1 - wx)
            + pix(y0, x0 + 1) * (1 - wy) * wx
            + pix(y0 + 1, x0) * wy * (1 - wx)
            + pix(y0 + 1, x0 + 1) * wy * wx)
