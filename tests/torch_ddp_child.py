"""Targets of the multi-process tests in tests/test_torch_distributed.py.

`lwsnet_tpu_torch.tools.dryrun_ddp.spawn` starts them in fresh processes,
which import this module by name: it imports torch and the port only,
never JAX.

`faulty_step_child` plants one of two faults at run time before the step:
"local_bn" keeps every batch norm's statistics to its own process (no
collective), "local_count" divides each process's loss by its own mask
count, as DDP's gradient averaging over per-process losses does
(grad = (1/P) sum_p grad(num_p / count_p)).
"""

import json
import logging
import os

import numpy as np
import torch

from lwsnet_tpu_torch.parallel import mesh
from lwsnet_tpu_torch.tools.dryrun_ddp import train_step_child


def faulty_step_child(rank, world, fault, *args):
    reduce_autograd, reduce_ = mesh.all_reduce_autograd, mesh.all_reduce_

    def local_bn(t, what):
        if what == "batch_norm":  # the caller divides by the count
            return t * mesh.process_count()
        return reduce_autograd(t, what)

    def local_count(t, what):
        if what == "loss_count":
            return t.mul_(mesh.process_count())
        return reduce_(t, what)

    if fault == "local_bn":
        mesh.all_reduce_autograd = local_bn
    elif fault == "local_count":
        mesh.all_reduce_ = local_count
    else:
        raise ValueError(fault)
    train_step_child(rank, world, *args)


def _trainer(rank, world, state_path, corpus_json, batch_size, out_dir,
             **train_kw):
    """A float32 Trainer on the CPU whose pipelines are this process's
    unshuffled slices of `corpus_json` ({"left", "right", "disp"} path
    lists) at 32x64, with the weights in `state_path`."""
    from lwsnet_tpu_torch import ModelConfig
    from lwsnet_tpu_torch.config import TrainConfig
    from lwsnet_tpu_torch.data.kitti2015 import StereoIndex
    from lwsnet_tpu_torch.data.pipeline import StereoPipeline
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

    with open(corpus_json) as f:
        idx = StereoIndex(**json.load(f))
    pipe = StereoPipeline(idx, batch_size, training=False, crop=(32, 64),
                          num_workers=1, process_index=rank,
                          process_count=world)
    trainer = Trainer(
        TrainerConfig(model=ModelConfig(compute_dtype="float32"),
                      train=TrainConfig(save_path=os.path.join(
                          out_dir, "unused"), **train_kw)),
        pipe, pipe, logging.getLogger("ddp_child"), device="cpu")
    trainer.init_state()
    trainer.state.model.load_state_dict(torch.load(state_path), strict=True)
    return trainer


def eval_child(rank, world, state_path, corpus_json, batch_size, out_dir):
    """`Trainer.evaluate` (EPE and D1) of this process's slice of the
    eval split in `corpus_json`, and the global sums, weights and `valid`
    vectors of its eval steps."""
    trainer = _trainer(rank, world, state_path, corpus_json, batch_size,
                       out_dir)
    pipe = trainer.eval_pipe
    steps, valid = [], []
    for batch in pipe.epoch(0):
        valid.append(batch.valid)
        out = trainer.eval_step(trainer.state, *[torch.from_numpy(a) for a in (
            batch.left, batch.right, batch.disparity, batch.valid)])
        steps.append({k: v.numpy() for k, v in out.items()})
    headline = {}
    for metric in ("epe", "d1"):
        trainer.tcfg.eval_metric = metric
        headline[metric] = trainer.evaluate()
    torch.save(dict(steps=steps, valid=np.stack(valid), headline=headline,
                    counts=mesh.collective_counts()),
               os.path.join(out_dir, f"eval{rank}.pt"))


def precise_bn_child(rank, world, state_path, corpus_json, batch_size,
                     out_dir):
    """`Trainer.reestimate_bn` (exact, one batch) over this process's
    slice of the unshuffled split in `corpus_json`; saves the buffers."""
    trainer = _trainer(rank, world, state_path, corpus_json, batch_size,
                       out_dir, bn_reestimate_batches=1,
                       bn_reestimate_exact=True)
    trainer.reestimate_bn(0)
    torch.save({n: b.clone() for n, b in trainer.state.model.named_buffers()},
               os.path.join(out_dir, f"bn{rank}.pt"))


def hang(rank, world):
    """Never returns: the target of the time-limit test."""
    import time
    while True:
        time.sleep(1.0)
