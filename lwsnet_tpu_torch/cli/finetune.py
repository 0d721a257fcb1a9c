"""KITTI2015 finetuning entry point of the port (reference: finetune.py).

    python -m lwsnet_tpu_torch.cli.finetune \
        --datapath dataset/kitti2015/training/ [--device cuda]

Bootstraps from the pretrain checkpoint (`--pretrained`, a port
checkpoint directory; "" for none) unless resuming; `--evaluate` runs one
validation pass and exits (reference: finetune.py:115-117). Logs go to
./log/. Data-parallel over N cards, one process each:

    torchrun --nproc_per_node=N -m lwsnet_tpu_torch.cli.finetune ...
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from lwsnet_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="KITTI2015 finetune")
    p.add_argument("--datapath", default="dataset/kitti2015/training/")
    p.add_argument("--pretrained", type=str, default="results/pretrained",
                   help="pretrain checkpoint dir to bootstrap from")
    p.add_argument("--val_set", type=str, default="",
                   help="validation split file; empty = builtin 40-frame split")
    p.add_argument("--evaluate", action="store_true")
    common.add_model_flags(p)
    common.add_data_flags(p, eval_height=368, eval_width=1232)
    common.add_train_flags(p, epochs=300, batch=4,
                           save_path="results/finetune")
    return p


def run(argv=None):
    """What `main` does; returns the Trainer after its run, with its state,
    its per-step `history` and the `last_error` it returned."""
    from lwsnet_tpu_torch.cli import common
    from lwsnet_tpu_torch.data.kitti2015 import index_kitti2015
    from lwsnet_tpu_torch.data.pipeline import StereoPipeline
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

    args = build_parser().parse_args(argv)
    log, pi, pc = common.setup("finetune", args)

    model_cfg = common.model_config(args)
    # finetune mask: gt > 0 (sparse KITTI GT, reference: finetune.py:153);
    # MultiStep decay milestones [200, 400] (reference: finetune.py:82-84).
    train_cfg = common.train_config(
        args, mask_min_disp=0.0, lr_milestones=(200, 400), lr_gamma=0.1)

    train_idx, val_idx = index_kitti2015(
        args.datapath, split_file=args.val_set or None)
    log.info("train %d examples, val %d examples", len(train_idx), len(val_idx))

    train_pipe = StereoPipeline(
        train_idx, args.train_batch_size, training=True,
        crop=(args.crop_height, args.crop_width),
        kitti=True, seed=args.seed, num_workers=args.num_workers,
        process_index=pi, process_count=pc)
    eval_pipe = StereoPipeline(
        val_idx, args.test_batch_size, training=False,
        crop=(args.eval_height, args.eval_width),
        kitti=True, num_workers=args.num_workers,
        process_index=pi, process_count=pc)

    trainer = Trainer(
        TrainerConfig(model=model_cfg, train=train_cfg, eval_metric="d1"),
        train_pipe, eval_pipe, log, device=args.device)
    trainer.init_state(args.seed)

    if args.resume:
        trainer.resume()
    elif args.pretrained:
        trainer.load_pretrained(args.pretrained)

    if args.evaluate:
        trainer.evaluate()
    else:
        trainer.fit()
    return trainer


def main(argv=None) -> float:
    """Finetune (or, with --evaluate, validate); returns the last
    validation D1."""
    return run(argv).last_error


if __name__ == "__main__":
    main()
