"""Targets of the row-sharding tests (tests/test_torch_halo.py,
tests/test_torch_spatial.py).

`lwsnet_tpu_torch.tools.dryrun_ddp.spawn` starts them in fresh processes
laid out as row shards, which import this module by name: it imports
torch, numpy and the port only, never JAX.

`halo_ops_child` runs every op of `HALO_CASES` and `MULTI_HOP_CASES` on
its rows of a 64-row image; `quad_child` the float64 train and eval
steps at 4 shards of 32 rows; `spatial_child` runs the row-sharded train
step, batch norm over unequal shards, a `Trainer` (train, precise BN and
the SceneFlow eval) and two planted faults: "zero_halo" gives every
shard zero rows at its seams (forward and backward), "shard_epe" divides
each shard's EPE and D1 sums by its own counts (no spatial reduction
before the division).
"""

import logging
import os
from contextlib import contextmanager

import numpy as np
import torch

from lwsnet_tpu_torch.data.pipeline import Batch
from lwsnet_tpu_torch.models import blocks
from lwsnet_tpu_torch.ops import stereo
from lwsnet_tpu_torch.parallel import halo, mesh

HALO_H = 64  # full-resolution rows of the halo cases' image


def _conv(stride, padding, dilation, groups=1):
    return lambda x, w: blocks.conv2d(x, w, stride, padding, dilation,
                                      groups)


def _resize(f):
    def run(x, w):
        h, wd = x.shape[1], x.shape[2]
        return stereo.resize_bilinear(x, int(h * f), int(wd * f))
    return run


# name -> (op(x, w), input shape, weight shape or None, row dim, input
# level, output level); a level is the map's 1/level of HALO_H rows.
HALO_CASES = {
    "conv_d1": (_conv(1, 1, 1), (2, 4, 64, 16), (5, 4, 3, 3), 2, 1, 1),
    "conv_d2": (_conv(1, 2, 2), (2, 4, 64, 16), (5, 4, 3, 3), 2, 1, 1),
    "conv_d4": (_conv(1, 4, 4), (2, 4, 64, 16), (5, 4, 3, 3), 2, 1, 1),
    "conv_d16": (_conv(1, 16, 16), (2, 4, 64, 40), (5, 4, 3, 3), 2, 1, 1),
    "depthwise_d8": (_conv(1, 8, 8, 4), (2, 4, 64, 24), (4, 1, 3, 3), 2,
                     1, 1),
    "stem_s2_d2": (_conv(2, 2, 2), (2, 3, 64, 16), (4, 3, 3, 3), 2, 1, 2),
    "conv_s2_d1": (_conv(2, 1, 1), (2, 4, 32, 16), (6, 4, 3, 3), 2, 2, 4),
    "deconv": (blocks.conv_transpose2d_up2, (2, 6, 8, 8), (6, 4, 3, 3), 2,
               8, 4),
    "conv3d": (blocks.conv3d, (1, 3, 5, 8, 12), (2, 3, 3, 3, 3), 3, 8, 8),
    "up_x2": (_resize(2), (2, 32, 12, 1), None, 1, 2, 1),
    "up_x4": (_resize(4), (2, 16, 8, 2), None, 1, 4, 1),
    "up_x8": (_resize(8), (2, 8, 6, 1), None, 1, 8, 1),
    "down_x2": (_resize(0.5), (2, 64, 16, 1), None, 1, 1, 2),
    "down_x4": (_resize(0.25), (2, 64, 16, 2), None, 1, 1, 4),
}
# A halo larger than a shard: dilation 16 at 1/4 resolution
TOO_TALL = (_conv(1, 16, 16), (1, 2, 16, 40), (2, 2, 3, 3), 2, 4, 4)


def _edge_conv(x, w):
    """A dilation-8 conv over rows extended by 8 repeated edge rows each
    side (the clamp `resize_bilinear` asks for), W padded with zeros."""
    if mesh.spatial_count() > 1:
        x = halo.extend_rows(x, 2, 8, 8, edge=True)
    else:
        x = torch.cat([x[:, :, :1].expand(-1, -1, 8, -1), x,
                       x[:, :, -1:].expand(-1, -1, 8, -1)], 2)
    return torch.nn.functional.conv2d(x, w, None, 1, (0, 8), 8)


# Halos taller than a shard at 4 shards of the 64-row image (16 rows at
# full resolution, 8 at 1/2, 4 at 1/4), filled from several shards and,
# past the image's edges, with zeros or repeated edge rows. Same tuple
# layout as HALO_CASES; seeded apart from them (`_seed`).
MULTI_HOP_CASES = {
    "too_tall": TOO_TALL,
    "conv_d16_l2": (_conv(1, 16, 16), (2, 4, 32, 24), (3, 4, 3, 3), 2, 2,
                    2),
    "conv_s2_d8_l4": (_conv(2, 8, 8), (2, 3, 16, 16), (4, 3, 3, 3), 2, 4,
                      8),
    "edge_d8_l4": (_edge_conv, (2, 3, 16, 20), (4, 3, 3, 3), 2, 4, 4),
}
# A halo taller than the whole image: dilation 16 at 1/8 resolution (8
# rows); raises at every world size
PAST_IMAGE = (_conv(1, 16, 16), (1, 2, 8, 40), (2, 2, 3, 3), 2, 8, 8)


def _seed(name):
    if name in HALO_CASES:
        return sorted(HALO_CASES).index(name)
    if name == "too_tall":
        return 99
    if name in MULTI_HOP_CASES:
        return 100 + sorted(MULTI_HOP_CASES).index(name)
    return 199


def halo_inputs(name, case):
    """The case's full input, weight and output gradient, from a seed."""
    op, shape, wshape, dim, _, _ = case
    rng = np.random.default_rng(_seed(name))
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    w = (torch.from_numpy(rng.standard_normal(wshape).astype(np.float32))
         if wshape else None)
    with torch.no_grad():
        y = op(x, w)
    g = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    return x, w, g


def level_rows(level):
    """This process's rows of a map at 1/level of HALO_H."""
    r0, r1 = mesh.row_range(HALO_H)
    return slice(r0 // level, r1 // level)


def run_case(case, x, w, g, rows_in=slice(None), rows_out=slice(None)):
    """The op on rows `rows_in` of x (and `rows_out` of the output
    gradient): (output, input gradient, weight gradient)."""
    op, _, _, dim, _, _ = case
    idx = [slice(None)] * x.dim()
    idx[dim] = rows_in
    x = x[tuple(idx)].clone().requires_grad_(True)
    w = w.clone().requires_grad_(True) if w is not None else None
    y = op(x, w)
    idx = [slice(None)] * y.dim()
    idx[dim] = rows_out
    y.backward(g[tuple(idx)])
    return (y.detach(), x.grad, w.grad if w is not None else None)


def halo_ops_child(rank, world, out_dir):
    """Every case of HALO_CASES and MULTI_HOP_CASES on this process's rows;
    saves each one's local output, input and weight gradients and its
    "halo" count to `<out_dir>/halo<rank>.pt`, and PAST_IMAGE's
    ValueError message."""
    out = {}
    for name, case in {**HALO_CASES, **MULTI_HOP_CASES}.items():
        x, w, g = halo_inputs(name, case)
        mesh.reset_collective_counts()
        y, dx, dw = run_case(case, x, w, g, level_rows(case[4]),
                             level_rows(case[5]))
        out[name] = dict(y=y, dx=dx, dw=dw,
                         halo=mesh.collective_counts().get("halo", 0))
    x, w, g = halo_inputs("past_image", PAST_IMAGE)
    try:
        run_case(PAST_IMAGE, x, w, g, level_rows(8), level_rows(8))
        out["past_image"] = None
    except ValueError as e:
        out["past_image"] = str(e)
    torch.save(out, os.path.join(out_dir, f"halo{rank}.pt"))


# --- the row-sharded training step, Trainer and eval -----------------------


class ArrayPipeline:
    """A pipeline over in-memory batches: the Trainer's `StereoPipeline`
    interface, one data slice."""

    process_index, process_count = 0, 1

    def __init__(self, batches):
        self.batches = batches

    def batches_per_epoch(self):
        return len(self.batches)

    def epoch(self, epoch=0):
        return iter(self.batches)


def trainer(state_path, data, sceneflow_row_offset=4, **train_kw):
    """A float32 Trainer on the CPU over `data` (npz arrays: train l, r, g;
    eval el, er, eg, ev), from the weights in `state_path`, laid out as
    the process group's row shards (one data slice)."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import MeshConfig, TrainConfig
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

    train = ArrayPipeline([Batch(data["l"], data["r"], data["g"],
                                 np.ones(len(data["l"]), np.float32))])
    evaluate = ArrayPipeline([Batch(data["el"], data["er"], data["eg"],
                                    data["ev"])])
    t = Trainer(TrainerConfig(
        model=ModelConfig(compute_dtype="float32"),
        train=TrainConfig(lr=5e-4, mask_max_disp=192.0, log_every=1,
                          bn_reestimate_batches=1, bn_reestimate_exact=True,
                          save_path=os.devnull, **train_kw),
        eval_metric="epe", sceneflow_row_offset=sceneflow_row_offset),
        train, evaluate, logging.getLogger("spatial_child"),
        device="cpu", mesh_cfg=MeshConfig(
            spatial_parallel=mesh.spatial_count()))
    t.init_state()
    t.state.model.load_state_dict(torch.load(state_path), strict=True)
    return t


def fit_record(t):
    """One epoch of `t` (train step, exact precise BN, eval): its history,
    the eval steps' sums, the headline EPE and D1, and the state after
    the train step ("trained") and at the end."""
    sums = []
    step = t.eval_step

    def recording(*args):
        out = step(*args)
        sums.append({k: v.clone() for k, v in out.items()})
        return out

    def state():
        return {k: v.clone() for k, v in t.state.model.state_dict().items()}

    t.eval_step = recording
    t.train_epoch(0)
    trained = state()
    t.reestimate_bn(0)
    epe = t.evaluate()
    t.tcfg.eval_metric = "d1"
    d1 = t.evaluate()
    return dict(history=t.history, sums=sums[0], epe=epe, d1=d1,
                trained=trained, state=state())


def step_record(state_path, batch, train_kw, dtype="float32",
                eval_batch=None):
    """One train step in `dtype` compute on this process's part of
    `batch`: its aux, the gradients the update used, the parameters,
    Adam's moments and the buffers after it, and the collective counts;
    with `eval_batch` (l, r, g) also the eval step's sums on this
    process's part of it before the train step ("eval": float32 running
    statistics would carry the step's rounding into the eval)."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.tools.dryrun_ddp import local_part
    from lwsnet_tpu_torch.training.state import create_train_state
    from lwsnet_tpu_torch.training.steps import make_eval_step, \
        make_train_step

    cfg = TrainConfig(**train_kw)
    st = create_train_state(ModelConfig(compute_dtype=dtype), cfg,
                            device="cpu")
    st.model.load_state_dict(torch.load(state_path), strict=True)
    evaluated = {}
    if eval_batch is not None:
        left, right, gt = local_part(eval_batch, "lrg")
        evaluated["eval"] = make_eval_step()(
            st, left, right, gt, torch.ones(len(left), dtype=torch.float32))
    mesh.reset_collective_counts()
    st, aux = make_train_step(cfg, 1)(st, *local_part(batch, "lrg"))
    named = list(st.model.named_parameters())
    moments = {k: {n: st.optimizer.state[p][k].clone() for n, p in named}
               for k in ("exp_avg", "exp_avg_sq")}
    return dict(aux=aux, counts=mesh.collective_counts(), **moments,
                grads={n: p.grad.clone() for n, p in named},
                params={n: p.detach().clone() for n, p in named},
                buffers={n: b.clone() for n, b in st.model.named_buffers()},
                **evaluated)


def steps_child(rank, world, batch_path, state_path, train_kw, out_dir):
    """`step_record` in float32 and float64 on `batch_path`'s batch;
    saves {dtype: record} to `<out_dir>/rank<rank>.pt`."""
    batch = dict(np.load(batch_path))
    torch.save({dtype: step_record(state_path, batch, train_kw, dtype)
                for dtype in ("float32", "float64")},
               os.path.join(out_dir, f"rank{rank}.pt"))


def quad_child(rank, world, state_path, data_path, train_kw, out_dir):
    """The 1x4 case of tests/test_torch_spatial.py: the float64 eval step
    and train step at 32 rows (8 a shard at full resolution, 1 at
    1/8, dilation-16 halos from two shards away). Saves
    `<out_dir>/quad<rank>.pt`."""
    data = dict(np.load(data_path))
    batch = {k: data[k + "32"] for k in "lrg"}
    evb = {k: data["e" + k + "32"] for k in "lrg"}
    torch.save(step_record(state_path, batch, train_kw, "float64", evb),
               os.path.join(out_dir, f"quad{rank}.pt"))


@contextmanager
def planted(fault):
    """Patch one fault into the halo or mesh module for the duration."""
    gather, reduce_ = halo._gather, mesh.all_reduce_spatial_

    def zero_halo(parts, dtype, extra):
        """Every slab sent zero, forward and backward; row counts kept."""
        return gather([torch.zeros_like(p) for p in parts], dtype, extra)

    def shard_epe(t, what):
        return t if what == "eval_shards" else reduce_(t, what)

    if fault == "zero_halo":
        halo._gather = zero_halo
    elif fault == "shard_epe":
        mesh.all_reduce_spatial_ = shard_epe
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        halo._gather, mesh.all_reduce_spatial_ = gather, reduce_


def spatial_child(rank, world, state_path, data_path, train_kw, out_dir):
    """The row-sharded cases of tests/test_torch_spatial.py in one process
    group: the train step at 64 rows in float32 ("step") and float64
    compute ("step64"), at 88 rows in unequal shards ("step88"), a Trainer
    epoch with the SceneFlow eval ("fit"), and the planted faults
    ("zero_halo": the step; "shard_epe": the Trainer's eval). Saves
    `<out_dir>/spatial<rank>.pt`."""
    data = dict(np.load(data_path))
    batch = {k: data[k] for k in "lrg"}
    batch88 = {k: data[k + "88"] for k in "lrg"}
    out = dict(rows=mesh.row_range(batch88["l"].shape[1]),
               step=step_record(state_path, batch, train_kw),
               step64=step_record(state_path, batch, train_kw, "float64"),
               step88=step_record(state_path, batch88, train_kw))
    t = trainer(state_path, data)
    out["fit"] = fit_record(t)
    with planted("zero_halo"):
        out["zero_halo"] = step_record(state_path, batch, train_kw)
    with planted("shard_epe"):
        t = trainer(state_path, data)
        t.state.model.load_state_dict(out["fit"]["state"])
        t.tcfg.eval_metric = "epe"
        out["shard_epe"] = t.evaluate()
    torch.save(out, os.path.join(out_dir, f"spatial{rank}.pt"))
