"""Halo exchange of image rows between the processes of a spatial group.

Under row sharding (`parallel/mesh.py`) each process holds rows [r0, r1)
of every map. A convolution reads rows beyond its shard, and an upscale
one row each side; under pjit GSPMD inserts those exchanges, here
`extend_rows` makes them. It extends a tensor along one dimension by `top`
rows of the spatial predecessor's last rows and `bottom` rows of the
successor's first ones. Past the image's global edges it fills zeros (a
convolution's padding) or repeats the edge row (`edge=True`: the clamp of
a bilinear resize). Its backward sends each halo row's gradient back to
the process that owns the row, which adds it; the gradients of zero rows
are dropped, and those of repeated edge rows go to the edge row.

One exchange is one `all_gather` over the spatial group of every
process's two edge slabs (its first `bottom` rows, its last `top` rows),
from which each process picks its neighbours'. It runs on NCCL and on
gloo alike and moves `spatial_parallel` x a few rows; each counts once
under "halo" in `mesh.collective_counts()`, forward and backward. The
slabs travel in at least float32 with each process's row count appended,
so that every process sees every shard's size and all raise together
when a halo is larger than the neighbouring shard.
"""

from __future__ import annotations

from typing import List

import torch

from lwsnet_tpu_torch.parallel import mesh


def _fit(t: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    """`t` cut or zero-padded at its end along `dim` to `rows` rows."""
    if t.shape[dim] >= rows:
        return t.narrow(dim, 0, rows)
    shape = list(t.shape)
    shape[dim] = rows - t.shape[dim]
    return torch.cat([t, t.new_zeros(shape)], dim)


def _slab_shape(x: torch.Tensor, dim: int, rows: int) -> List[int]:
    shape = list(x.shape)
    shape[dim] = rows
    return shape


def _gather(parts: List[torch.Tensor], dtype: torch.dtype,
            extra: List[float]) -> List[torch.Tensor]:
    """The flat concatenation of `parts` (and `extra` values) of every
    process of the spatial group, in `dtype`."""
    flat = [p.reshape(-1).to(dtype) for p in parts]
    if extra:
        flat.append(torch.tensor(extra, dtype=dtype, device=parts[0].device))
    return mesh.all_gather_spatial(torch.cat(flat), "halo")


def _edge_rows(x: torch.Tensor, dim: int, index: int, rows: int
               ) -> torch.Tensor:
    return x.narrow(dim, index, 1).expand(_slab_shape(x, dim, rows))


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, dim, top, bottom, edge):
        s, n = mesh.spatial_index(), mesh.spatial_count()
        L = x.shape[dim]
        acc = torch.promote_types(x.dtype, torch.float32)
        head = _fit(x, dim, bottom)                       # for s - 1
        tail = _fit(x.narrow(dim, max(0, L - top), min(top, L)), dim, top)
        got = _gather([head, tail], acc, [float(L)])      # for s + 1
        sizes = torch.stack([g[-1] for g in got]).int().tolist()
        short = [r for r in range(n)
                 if (r > 0 and sizes[r - 1] < top)
                 or (r < n - 1 and sizes[r + 1] < bottom)]
        if short:
            raise ValueError(
                f"halo of {top} rows above and {bottom} below along dim "
                f"{dim} exceeds a neighbouring shard: shards of {sizes} "
                f"rows at this level ({n} shards); use fewer row shards or "
                f"taller images")
        nb = head.numel()
        if s > 0:
            above = got[s - 1][nb:nb + tail.numel()].view(
                _slab_shape(x, dim, top)).to(x.dtype)
        elif edge:
            above = _edge_rows(x, dim, 0, top)
        else:
            above = x.new_zeros(_slab_shape(x, dim, top))
        if s < n - 1:
            below = got[s + 1][:nb].view(
                _slab_shape(x, dim, bottom)).to(x.dtype)
        elif edge:
            below = _edge_rows(x, dim, L - 1, bottom)
        else:
            below = x.new_zeros(_slab_shape(x, dim, bottom))
        ctx.geometry = (dim, top, bottom, edge, L)
        return torch.cat([above, x, below], dim)

    @staticmethod
    def backward(ctx, g):
        dim, top, bottom, edge, L = ctx.geometry
        s, n = mesh.spatial_index(), mesh.spatial_count()
        acc = torch.promote_types(g.dtype, torch.float32)
        g_above = g.narrow(dim, 0, top)            # rows of s - 1
        g_below = g.narrow(dim, top + L, bottom)   # rows of s + 1
        got = _gather([g_above, g_below], acc, [])
        dx = g.narrow(dim, top, L).to(acc, copy=True)
        if s < n - 1:    # s + 1's top halo: this shard's last rows
            dx.narrow(dim, L - top, top).add_(
                got[s + 1][:g_above.numel()].view(g_above.shape))
        elif edge:
            dx.narrow(dim, L - 1, 1).add_(
                g_below.to(acc).sum(dim, keepdim=True))
        if s > 0:        # s - 1's bottom halo: this shard's first rows
            dx.narrow(dim, 0, bottom).add_(
                got[s - 1][g_above.numel():].view(g_below.shape))
        elif edge:
            dx.narrow(dim, 0, 1).add_(g_above.to(acc).sum(dim, keepdim=True))
        return dx.to(g.dtype), None, None, None, None


def extend_rows(x: torch.Tensor, dim: int, top: int, bottom: int,
                edge: bool = False) -> torch.Tensor:
    """`x` (this process's rows along `dim`) with `top` rows of the
    spatial predecessor above and `bottom` rows of the successor below;
    zeros past the image's global edges, or the edge row repeated with
    `edge`. Only under row sharding (`mesh.spatial_count() > 1`); no
    exchange for a halo of 0 rows. Raises ValueError, on every process of
    the group, when a halo is larger than the neighbouring shard."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, dim, top, bottom, edge)
