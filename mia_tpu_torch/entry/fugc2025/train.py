"""``fugc2025_train_torch`` console entry: the PyTorch port of
``fugc2025_train`` (``mia_tpu/entry/fugc2025/train.py``): K-fold supervised
FUGC training with the same flags → ``UNetTrainer``.

``--device`` defaults to ``cuda`` and raises when no card is present; pass
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser()
    parser.add_argument("--work-dir", default=".", type=str)
    parser.add_argument("--log-file", default=None, type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--data-dir", required=True, type=str)
    parser.add_argument("--split-dicts", default=None)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--seed", default=1337, type=int)

    parser.add_argument("--num-classes", default=3, type=int)
    parser.add_argument("--image-size", default=None, nargs="+", type=int)

    parser.add_argument("--num-folds", default=5, type=int)
    parser.add_argument("--fold", default="all")
    parser.add_argument("--valid-rate", default=0.2, type=float)

    parser.add_argument("--num-epochs", default=1000, type=int)
    parser.add_argument("--batch-size", default=32, type=int)
    parser.add_argument("--valid-freq-iter", default=200, type=int)
    parser.add_argument("--optimizer", default="adam", type=str)
    parser.add_argument("--warmup-steps", default=0, type=int)
    parser.add_argument("--weight-decay", default=0.1, type=float)
    parser.add_argument("--start-lr", default=1e-3, type=float)
    parser.add_argument("--oversample", default=1, type=int)
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--no-normalization", action="store_true")
    return parser.parse_args(argv)


def train_entry(argv=None):
    import json

    from mia_tpu_torch.training.unet_trainer import UNetTrainer

    args = parse_args(argv)
    image_size = args.image_size
    if image_size and len(image_size) == 1:
        image_size = image_size * 2

    split_dicts = None
    if args.split_dicts:
        with open(args.split_dicts) as f:
            split_dicts = json.load(f)

    config = dict(
        seed=args.seed,
        dataset="fugc",
        data_path=args.data_dir,
        in_channels=3,
        # reference convention: num_classes excludes background
        num_classes=args.num_classes - 1,
        image_size=tuple(image_size) if image_size else None,
        batch_size=args.batch_size,
        valid_mode="slice",
        active_learning=False,
        model_ckpt=args.checkpoint,
        do_augment=not args.no_augment,
        do_normalize=not args.no_normalization,
        do_oversample=args.oversample > 1,
        optimizer_name=args.optimizer,
        optimizer_kwargs={"weight_decay": args.weight_decay},
        start_lr=args.start_lr,
        lr_warmup_iter=args.warmup_steps,
        valid_freq_iter=args.valid_freq_iter,
    )
    trainer = UNetTrainer(
        work_path=args.work_dir,
        device=args.device,
        config=config,
        log_path=args.log_file,
        num_folds=args.num_folds,
        fold=args.fold,
        valid_rate=args.valid_rate,
        num_epochs=args.num_epochs,
        split_dicts=split_dicts,
    )
    trainer.initialize()
    trainer.run_training()
    return trainer


def main():
    train_entry()


if __name__ == "__main__":
    main()
