"""Core stereo ops in plain PyTorch: horizontal warp, cost volumes,
soft-argmin, bilinear resize.

The same functions as the JAX package's `ops/stereo.py`, with its layouts:
features and images (B, H, W, C), disparities (B, H, W) or (B, H, W, 1),
cost volumes (B, H, W, D). The JAX residual volume warps with a one-hot
interpolation matrix on the TPU's matrix unit; here the bilinear taps are
gathered directly, which is the same arithmetic.

Under row sharding (`parallel/mesh.py`) the cost volumes, the warp and the
soft-argmin work along W and the disparity axis, so they run on a shard's
rows as they stand; `resize_bilinear` takes the one halo row each side an
integer upscale reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lwsnet_tpu_torch.parallel import halo, mesh


def _squeeze_disp(disp: torch.Tensor) -> torch.Tensor:
    return disp[..., 0] if disp.dim() == 4 else disp


def _gather_w(feat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W', C) gathered along W' at idx (B, H, W) -> (B, H, W, C)."""
    C = feat.shape[-1]
    return torch.gather(feat, 2, idx[..., None].expand(*idx.shape, C))


def horizontal_warp(feat: torch.Tensor, disp: torch.Tensor) -> torch.Tensor:
    """Sample `feat` at x' = x - disp with 1-D bilinear weights, zeros out
    of bounds (grid_sample, align_corners=True, padding_mode="zeros").

    feat: (B, H, W, C); disp: (B, H, W) or (B, H, W, 1). Returns (B, H, W, C).
    """
    disp = _squeeze_disp(disp)
    W = feat.shape[2]
    x = torch.arange(W, dtype=disp.dtype, device=disp.device)
    xs = x - disp
    x0 = torch.floor(xs)
    w1 = (xs - x0).to(feat.dtype)
    w0 = (1.0 - w1).to(feat.dtype)
    x0i = x0.long()

    def tap(idx, w):
        valid = (idx >= 0) & (idx < W)
        g = _gather_w(feat, idx.clamp(0, W - 1))
        return g * (w * valid.to(feat.dtype))[..., None]

    return tap(x0i, w0) + tap(x0i + 1, w1)


def build_cost_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                      max_disp: int) -> torch.Tensor:
    """Full L1 cost volume over integer disparities [0, max_disp):
    cost[b, h, w, d] = sum_c |feat_l[b,h,w,c] - feat_r[b,h,w-d,c]|, with
    feat_r zero for w - d < 0 (so the occluded strip gets sum_c |feat_l|).

    feat_l, feat_r: (B, H, W, C). Returns (B, H, W, max_disp).
    """
    W = feat_l.shape[2]
    pad = F.pad(feat_r, (0, 0, max_disp - 1, 0))
    return torch.stack([
        (feat_l - pad[:, :, max_disp - 1 - d:max_disp - 1 - d + W]).abs()
        .sum(-1) for d in range(max_disp)], dim=-1)


def build_residual_volume(feat_l: torch.Tensor, feat_r: torch.Tensor,
                          disp: torch.Tensor, max_disp: int,
                          stride: int = 1) -> torch.Tensor:
    """Residual cost volume over offsets o_k = (k - max_disp + 1) * stride,
    k = 0 .. 2*max_disp-2:

        cost[..., k] = sum_c |feat_l - warp(feat_r, disp - o_k)|

    Each hypothesis samples feat_r at x - disp + o_k from its two bilinear
    taps; a tap outside [0, W) contributes zero, also when only one of the
    two taps is outside. The fractional weight is rounded to the feature
    dtype, and the two-tap sum is formed in float32 (float64 for float64
    features) and rounded once, as the JAX interpolation-matrix product
    does. Disparities stay float32 (float64).

    feat_l, feat_r: (B, H, W, C); disp: (B, H, W) or (B, H, W, 1).
    Returns (B, H, W, 2*max_disp-1).
    """
    dtype = feat_r.dtype
    acc = torch.promote_types(dtype, torch.float32)
    disp = _squeeze_disp(disp).to(acc)
    W = feat_r.shape[2]
    P = max_disp * stride
    x = torch.arange(W, dtype=acc, device=disp.device)
    base = x - disp + P
    i0 = torch.floor(base)
    frac = (base - i0).to(dtype)
    w1 = frac.to(acc)[..., None]
    w0 = (1.0 - frac).to(acc)[..., None]
    q0 = i0.long() - P
    # One zero column each side: clamping a tap index into [-1, W] lands
    # every out-of-bounds tap on a zero.
    padded = F.pad(feat_r, (0, 0, 1, 1)).to(acc)
    costs = []
    for k in range(2 * max_disp - 1):
        q = q0 + (k - max_disp + 1) * stride
        t0 = _gather_w(padded, q.clamp(-1, W) + 1)
        t1 = _gather_w(padded, (q + 1).clamp(-1, W) + 1)
        warped = (w0 * t0 + w1 * t1).to(dtype)
        costs.append((feat_l - warped).abs().sum(-1))
    return torch.stack(costs, dim=-1)


def soft_argmin(cost: torch.Tensor, start: int, end: int,
                stride: int = 1) -> torch.Tensor:
    """Expectation of the disparity bins arange(start, end) * stride under
    softmax(-cost) over the last axis. cost: (B, H, W, D) with
    D == end - start. Returns (B, H, W, 1) float32 (float64 for a float64
    cost)."""
    acc = torch.promote_types(cost.dtype, torch.float32)
    bins = torch.arange(start * stride, end * stride, stride,
                        dtype=acc, device=cost.device)
    probs = torch.softmax(-cost.to(acc), dim=-1)
    return (probs * bins).sum(-1, keepdim=True)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False), edge
    clamping and no antialias on downscale, computed in float32 (float64
    for float64 input) and cast back. x: (B, H, W, C).

    Under row sharding x holds this process's rows and `height` the
    resized shard's. An upscale by an integer factor f reads one source
    row beyond each shard edge: the shard takes them from its neighbours,
    the image's edge row repeated at its global edges (the clamp), and
    keeps output rows f .. f + height of the extended resize. A downscale
    by an even factor f reads source rows f o + f / 2 - 1 and f o + f / 2,
    inside the shard; other factors raise ValueError there."""
    H, W = x.shape[1], x.shape[2]
    if H == height and W == width:
        return x
    acc = torch.promote_types(x.dtype, torch.float32)
    y = x.permute(0, 3, 1, 2).to(acc)
    if mesh.spatial_count() > 1 and H != height:
        if height > H and height % H == 0:
            f = height // H
            y = F.interpolate(halo.extend_rows(y, 2, 1, 1, edge=True),
                              size=(height + 2 * f, width), mode="bilinear",
                              align_corners=False, antialias=False)
            return y[:, :, f:f + height].permute(0, 2, 3, 1).to(x.dtype)
        if height > H or H % height or (H // height) % 2:
            raise ValueError(f"resize of a row shard from {H} to {height} "
                             f"rows: only integer upscales and even "
                             f"downscales split on rows")
    y = F.interpolate(y, size=(height, width),
                      mode="bilinear", align_corners=False, antialias=False)
    return y.permute(0, 2, 3, 1).to(x.dtype)
