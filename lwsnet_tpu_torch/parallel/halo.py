"""Halo exchange of image rows between the processes of a spatial group.

Under row sharding (`parallel/mesh.py`) each process holds rows [r0, r1)
of every map. A convolution reads rows beyond its shard, and an upscale
one row each side; under pjit GSPMD inserts those exchanges, here
`extend_rows` makes them. It extends a tensor along one dimension by the
`top` rows just above the shard and the `bottom` rows just below it,
which may span several neighbouring shards: a dilation-16 tower on 8-row
shards reads two shards up and two down. Past the image's global edges
it fills zeros (a convolution's padding) or repeats the edge row
(`edge=True`: the clamp of a bilinear resize). Its backward sends each
halo row's gradient back to the process that owns the row, however many
shards away, which adds it; the gradients of zero rows are dropped, and
those of repeated edge rows go to the edge row.

One exchange is one `all_gather` over the spatial group of every
process's two edge slabs (its first min(L, `bottom`) rows and its last
min(L, `top`) rows, each zero-padded to `bottom` and `top` rows), from
which each process assembles its halo: the predecessors' last rows,
nearest first, until `top` rows are filled or the image's top edge is
reached, and the successors' first rows likewise. A shard shorter than
the halo thus passes on all its rows, and the next shard out supplies
the rest. It runs on NCCL and on gloo alike and moves `spatial_parallel`
x a few rows; each counts once under "halo" in
`mesh.collective_counts()`, forward and backward. The slabs travel in at
least float32 with each process's row count appended, so that every
process sees every shard's size and all raise together when a halo is
taller than the whole image at that level.
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
        head = _fit(x, dim, bottom)                       # for s - 1, ...
        tail = _fit(x.narrow(dim, max(0, L - top), min(top, L)), dim, top)
        got = _gather([head, tail], acc, [float(L)])      # for s + 1, ...
        sizes = torch.stack([g[-1] for g in got]).int().tolist()
        height = sum(sizes)
        if max(top, bottom) > height:
            raise ValueError(
                f"halo of {top} rows above and {bottom} below along dim "
                f"{dim} reaches past the whole image: shards of {sizes} "
                f"rows at this level ({n} shards); use taller images")
        nb = head.numel()
        above, need = [], top
        for r in range(s - 1, -1, -1):                    # nearest first
            if need == 0:
                break
            have = min(sizes[r], top)
            k = min(have, need)
            above.insert(0, got[r][nb:nb + tail.numel()].view(
                _slab_shape(x, dim, top)).narrow(dim, have - k, k))
            need -= k
        if need:                                          # the top edge
            above.insert(0, _edge_rows(above[0] if above else x, dim, 0,
                                       need) if edge else
                         x.new_zeros(_slab_shape(x, dim, need)))
        below, need = [], bottom
        for r in range(s + 1, n):
            if need == 0:
                break
            k = min(sizes[r], bottom, need)
            below.append(got[r][:nb].view(
                _slab_shape(x, dim, bottom)).narrow(dim, 0, k))
            need -= k
        if need:                                          # the bottom edge
            last = below[-1] if below else x
            below.append(_edge_rows(last, dim, last.shape[dim] - 1, need)
                         if edge else
                         x.new_zeros(_slab_shape(x, dim, need)))
        ctx.geometry = (dim, top, bottom, edge, sizes)
        return torch.cat([p.to(x.dtype) for p in above] + [x]
                         + [p.to(x.dtype) for p in below], dim)

    @staticmethod
    def backward(ctx, g):
        dim, top, bottom, edge, sizes = ctx.geometry
        s, n = mesh.spatial_index(), mesh.spatial_count()
        L = sizes[s]
        starts = [sum(sizes[:r]) for r in range(n + 1)]
        acc = torch.promote_types(g.dtype, torch.float32)
        g_above = g.narrow(dim, 0, top)            # rows of s - 1, ...
        g_below = g.narrow(dim, top + L, bottom)   # rows of s + 1, ...
        got = _gather([g_above, g_below], acc, [])
        na = g_above.numel()
        dx = g.narrow(dim, top, L).to(acc, copy=True)
        # The top halos of the successors r: rows above r's first one,
        # the last `top - gap` of them this shard's (gap rows between).
        for r in range(s + 1, n):
            gap = starts[r] - starts[s + 1]
            if gap >= top:
                break
            k = min(L, top - gap)
            dx.narrow(dim, L - k, k).add_(got[r][:na].view(
                g_above.shape).narrow(dim, top - gap - k, k))
        if edge and s == n - 1:    # every bottom halo's rows past the edge
            for r in range(n):
                past = bottom - (starts[n] - starts[r + 1])
                if past > 0:
                    dx.narrow(dim, L - 1, 1).add_(got[r][na:].view(
                        g_below.shape).narrow(dim, bottom - past, past)
                        .sum(dim, keepdim=True))
        # The bottom halos of the predecessors r: rows below r's last one.
        for r in range(s - 1, -1, -1):
            gap = starts[s] - starts[r + 1]
            if gap >= bottom:
                break
            k = min(L, bottom - gap)
            dx.narrow(dim, 0, k).add_(got[r][na:].view(
                g_below.shape).narrow(dim, gap, k))
        if edge and s == 0:        # every top halo's rows past the edge
            for r in range(n):
                past = top - starts[r]
                if past > 0:
                    dx.narrow(dim, 0, 1).add_(got[r][:na].view(
                        g_above.shape).narrow(dim, 0, past)
                        .sum(dim, keepdim=True))
        return dx.to(g.dtype), None, None, None, None


def extend_rows(x: torch.Tensor, dim: int, top: int, bottom: int,
                edge: bool = False) -> torch.Tensor:
    """`x` (this process's rows along `dim`) with `top` rows of the
    spatial predecessor above and `bottom` rows of the successor below;
    zeros past the image's global edges, or the edge row repeated with
    `edge`. The rows may come from several shards when the neighbouring
    ones are shorter than the halo. Only under row sharding
    (`mesh.spatial_count() > 1`); no exchange for a halo of 0 rows.
    Raises ValueError, on every process of the group, when a halo is
    taller than the whole image along `dim` (the sum of the shards'
    rows): it would reach past every row on that side."""
    if top == 0 and bottom == 0:
        return x
    return _Halo.apply(x, dim, top, bottom, edge)
