"""SceneFlow pretraining entry point of the port (reference: train.py).

    python -m lwsnet_tpu_torch.cli.pretrain --datapath dataset/sceneflow/ \
        [--device cuda]

The published recipe: batch 8 at a 256x512 crop, 10 epochs, the loss over
gt < maxdisp, validation on FlyingThings TEST in a 544x960 window whose
EPE drops the prediction's top 4 rows (the frames have 540). Best-only
checkpoints go to --save_path, which `cli.finetune --pretrained` reads.
Logs go to ./log/. Data-parallel over N cards, one process each:

    torchrun --nproc_per_node=N -m lwsnet_tpu_torch.cli.pretrain ...
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    from lwsnet_tpu_torch.cli import common

    p = argparse.ArgumentParser(description="SceneFlow pretrain")
    p.add_argument("--datapath", default="dataset/sceneflow/")
    p.add_argument("--sceneflow_compat_15mm", action="store_true",
                   help="reproduce the reference's duplicated 15mm driving "
                        "split (reference: dataloader/sceneflow.py:105)")
    common.add_model_flags(p)
    common.add_data_flags(p, eval_height=544, eval_width=960)
    common.add_train_flags(p, epochs=10, batch=8,
                           save_path="results/pretrained")
    return p


def run(argv=None):
    """What `main` does; returns the Trainer after its run, with its state,
    its per-step `history` and the `last_error` (EPE) it returned."""
    from lwsnet_tpu_torch.cli import common
    from lwsnet_tpu_torch.data.pipeline import StereoPipeline
    from lwsnet_tpu_torch.data.sceneflow import index_sceneflow
    from lwsnet_tpu_torch.training.loop import Trainer, TrainerConfig

    args = build_parser().parse_args(argv)
    log, pi, pc = common.setup("pretrain", args)

    model_cfg = common.model_config(args)
    # pretrain mask: gt < maxdisp (reference: train.py:137)
    train_cfg = common.train_config(args, mask_max_disp=float(args.maxdisp))

    train_idx, test_idx = index_sceneflow(
        args.datapath, compat_duplicate_15mm=args.sceneflow_compat_15mm)
    log.info("train %d examples, test %d examples",
             len(train_idx), len(test_idx))

    train_pipe = StereoPipeline(
        train_idx, args.train_batch_size, training=True,
        crop=(args.crop_height, args.crop_width),
        kitti=False, seed=args.seed, num_workers=args.num_workers,
        process_index=pi, process_count=pc)
    eval_pipe = StereoPipeline(
        test_idx, args.test_batch_size, training=False,
        crop=(args.eval_height, args.eval_width),
        kitti=False, num_workers=args.num_workers,
        process_index=pi, process_count=pc)

    trainer = Trainer(
        TrainerConfig(model=model_cfg, train=train_cfg, eval_metric="epe",
                      sceneflow_row_offset=4),
        train_pipe, eval_pipe, log, device=args.device)
    trainer.init_state(args.seed)
    if args.resume:
        trainer.resume()
    trainer.fit()
    return trainer


def main(argv=None) -> float:
    """Pretrain; returns the last validation EPE."""
    return run(argv).last_error


if __name__ == "__main__":
    main()
