"""The halo exchange of row sharding, op by op, on the CPU.

Gloo processes (`lwsnet_tpu_torch.tools.dryrun_ddp.spawn`, all cases in
one spawn per world size) each run one op of `torch_spatial_child.
HALO_CASES` on their rows of a 64-row image: convolutions k3 at dilations
1, 2, 4 and 16, a depthwise one, the feature stem's s2/d2 conv, the
hourglass's s2/d1 conv, the transposed conv, the 3D conv (rows on dim 3),
and bilinear resizes up x2/x4/x8 and down x2/x4. At world size 2 the
shards are 32/32 rows; at 3 they are 24/24/16, with a middle process that
has both neighbours; at 4 they are 16 rows each (8 at 1/2 resolution, 4
at 1/4, 2 at 1/8). The cases of `MULTI_HOP_CASES` have halos taller
than a shard, filled from two or more shards and, past the image's
edges, with zeros or repeated edge rows: dilation 16 at 1/4 resolution
(the shard of 4 rows at world size 4 reads four shards down), dilation
16 at 1/2, a stride-2 dilation-8 conv, and a dilation-8 conv over rows
extended with repeated edge rows. The gathered output, input gradient
and the summed weight gradient must equal the unsharded op within 1e-6
of the reference's span (float32), each op running one exchange forward
and one backward (none for a downscale). A dilation-16 halo at 1/8
resolution, where the whole image holds 8 rows, raises ValueError on
every process. The children import no JAX.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

import torch_spatial_child as child  # noqa: E402
from lwsnet_tpu_torch.parallel import mesh  # noqa: E402
from lwsnet_tpu_torch.tools import dryrun_ddp  # noqa: E402

TIMEOUT = 120.0


@pytest.fixture(scope="module", params=[2, 3, 4])
def ranks(request, tmp_path_factory):
    """Each process's record of every case, world size 2, 3 or 4."""
    tmp = tmp_path_factory.mktemp(f"halo{request.param}")
    world = request.param
    dryrun_ddp.spawn(child.halo_ops_child, world, (str(tmp),), TIMEOUT,
                     str(tmp), spatial=world)
    return [torch.load(str(tmp / f"halo{r}.pt")) for r in range(world)]


def test_shard_rows():
    """Boundaries on multiples of 8 rows, larger shards first."""
    assert mesh.shard_rows(368, 4) == [96, 96, 88, 88]
    assert mesh.shard_rows(88, 2) == [48, 40]
    assert mesh.shard_rows(64, 3) == [24, 24, 16]
    assert mesh.shard_rows(544, 2) == [272, 272]
    with pytest.raises(ValueError, match="multiple of 8"):
        mesh.shard_rows(100, 2)
    with pytest.raises(ValueError, match="cannot make"):
        mesh.shard_rows(16, 3)


@pytest.mark.parametrize("name", sorted(child.HALO_CASES)
                         + sorted(child.MULTI_HOP_CASES))
def test_sharded_op_matches_unsharded(ranks, name):
    case = {**child.HALO_CASES, **child.MULTI_HOP_CASES}[name]
    dim = case[3]
    x, w, g = child.halo_inputs(name, case)
    want = child.run_case(case, x, w, g)
    got = (torch.cat([r[name]["y"] for r in ranks], dim),
           torch.cat([r[name]["dx"] for r in ranks], dim),
           sum(r[name]["dw"] for r in ranks) if w is not None else None)
    for what, a, b in zip(("output", "input grad", "weight grad"), got,
                          want):
        if b is None:
            continue
        assert a.shape == b.shape, (what, a.shape, b.shape)
        span = float(b.max() - b.min())
        err = float((a - b).abs().max())
        assert err <= 1e-6 * span, (name, what, err, span)
    exchanges = 0 if name.startswith("down") else 2
    assert [r[name]["halo"] for r in ranks] == [exchanges] * len(ranks)


def test_halo_past_the_whole_image_raises(ranks):
    msgs = [r["past_image"] for r in ranks]
    assert all(m is not None and "reaches past the whole image" in m
               for m in msgs), msgs
