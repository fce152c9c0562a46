"""``al_train_torch`` console entry: the PyTorch port of ``al_train``
(``mia_tpu/entry/activelearning/train.py``), with the same flags → ALConfig
→ ALTrainer; ``--test-only`` runs ``perform_real_test`` instead of training.

``--device`` defaults to ``cuda`` and raises when no card is present; pass
``--device cpu`` to run on the CPU.
"""

from __future__ import annotations

from argparse import ArgumentParser


def parse_args(argv=None):
    parser = ArgumentParser()

    parser.add_argument("--work-path", default=".", type=str)
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--seed", default=1337, type=int)
    parser.add_argument("--test-only", action="store_true")
    parser.add_argument("--resume", default=None, type=str)
    parser.add_argument("--deterministic", dest="deterministic", action="store_true")
    parser.add_argument("--init-round-path", default=None, type=str)
    parser.add_argument("--init-data-list", default=None, type=str)

    # >>> Model parameters
    parser.add_argument("--in-channels", default=1, type=int)
    parser.add_argument("--num-classes", default=3, type=int)
    parser.add_argument("--postprocess-mask", action="store_true")
    parser.add_argument("--block-type", default="plain", type=str)
    parser.add_argument("--block-normalization", default="batch", type=str)
    parser.add_argument("--dropout-prob", default=0.1, type=float)
    parser.add_argument("--deep-supervision", action="store_true")
    parser.add_argument("--ds-layer", default=3, type=int)
    parser.add_argument("--patch-size", default=256, nargs="+", type=int)
    parser.add_argument("--image-size", default=256, nargs="+", type=int)
    parser.add_argument("--model-ckpt", default=None, type=str)
    parser.add_argument(
        "--compute-dtype", default="float32", choices=["float32", "bfloat16"]
    )
    # <<< Model parameters

    # >>> Data parameters
    parser.add_argument("--dataset", default="ACDC", type=str)
    parser.add_argument("--data-path", required=True, type=str)
    parser.add_argument("--do-oversample", action="store_true")
    parser.add_argument("--do-augment", action="store_true")
    parser.add_argument("--do-normalize", action="store_true")
    parser.add_argument("--batch-size", default=12, type=int)
    parser.add_argument("--valid-batch-size", default=1, type=int)
    parser.add_argument("--num-workers", default=1, type=int)
    parser.add_argument("--pin-memory", action="store_true")
    # <<< Data parameters

    # >>> Training parameters
    parser.add_argument("--supervise", dest="active_learning", action="store_false")
    parser.add_argument("--valid-mode", default="volumn", type=str)
    parser.add_argument("--num-rounds", default=5, type=int)
    parser.add_argument("--budget", default=10, type=int)
    parser.add_argument("--persist-model-weight", action="store_true")
    parser.add_argument("--active-selector", default="random", type=str)
    parser.add_argument("--feature-path", default=None, type=str)
    parser.add_argument("--loaded-feature-weight", default=0.0, type=float)
    parser.add_argument("--loaded-feature-only", action="store_true")
    parser.add_argument("--coreset-criteria", default="min", choices=["min", "mean"])
    parser.add_argument("--coreset-fusion", default="add", choices=["add", "cat"])
    parser.add_argument("--kmean-sharp-factor", default=1.0, type=float)
    parser.add_argument("--kmean-softmax", action="store_true")
    parser.add_argument("--optimizer", default="adam", type=str)
    parser.add_argument("--weight-decay", default=5e-4, type=float)
    parser.add_argument("--min-iter", default=0, type=int)
    parser.add_argument("--num-iters", default=4000, type=int)
    parser.add_argument("--start-lr", default=1e-3, type=float)
    parser.add_argument("--lr-scheduler", default="poly", type=str)
    parser.add_argument("--lr-interval", default=1, type=int)
    parser.add_argument("--lr-warmup-iter", default=250, type=int)
    parser.add_argument("--save-freq-epoch", default=None, type=int)
    parser.add_argument("--valid-freq-iter", default=200, type=int)
    parser.add_argument(
        "--log-every-iters", default=1, type=int,
        help="defer train metric fetches/log lines to every N iters "
        "(1 = reference per-iteration cadence)",
    )
    parser.add_argument("--save-metric", default="dice", type=str)
    parser.add_argument("--loss", default="dice+ce", type=str)
    parser.add_argument("--dice-weight", default=1.0, type=float)
    parser.add_argument("--ce-weight", default=1.0, type=float)
    parser.add_argument("--early-stop-max-patience", default=None, type=int)
    # <<< Training parameters

    # >>> Log parameters
    parser.add_argument("--quiet", dest="verbose", action="store_false")
    parser.add_argument("--log-path", default=None, type=str)
    parser.add_argument("--config-path", default=None, type=str)
    parser.add_argument("--exp-name", default="", type=str)
    parser.add_argument("--use-wandb", action="store_true")
    parser.add_argument("--wandb-api-key", default=None, type=str)
    # <<< Log parameters

    return parser.parse_args(argv)


def train_entry(argv=None):
    from mia_tpu_torch.training import ALTrainer

    args = parse_args(argv)
    args_dict = vars(args)
    test_only = args_dict.pop("test_only")
    args_dict["optimizer_name"] = args_dict.pop("optimizer")
    args_dict["optimizer_kwargs"] = {"weight_decay": args_dict.pop("weight_decay")}
    args_dict["lr_scheduler_name"] = args_dict.pop("lr_scheduler")
    args_dict["loss_name"] = args_dict.pop("loss")
    args_dict["save_metric_name"] = args_dict.pop("save_metric")
    args_dict["active_selector_name"] = args_dict.pop("active_selector")

    trainer = ALTrainer(config=args_dict, **args_dict)
    trainer.initialize()

    if test_only:
        trainer.perform_real_test()
    else:
        trainer.run_training()
    return trainer


def main():
    train_entry()


if __name__ == "__main__":
    main()
