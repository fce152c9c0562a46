"""K-fold supervised FUGC trainer and the labeled-ratio semi scaffold.

Counterpart of ``mia_tpu/training/unet_trainer.py``:

- ``UNetTrainer``: random cross-fold splits of the train set with a
  no-data-leak assertion, one supervised run per fold with fresh weights,
  per-fold ``fold_<i>/`` work paths, the fold's best checkpoint aliased to
  ``fold_<i>/model.msgpack``, as the JAX package names it.
- ``SemiTrainer``: labeled/unlabeled/valid split by ``labeled_ratio``; the
  loop is supervised on the labeled split, like the reference's.

Both reuse the ``ALTrainer`` core with active learning disabled.
"""

from __future__ import annotations

import shutil

import numpy as np

from ..data import ActiveDataset, BatchLoader, ExtendableDataset
from .al_trainer import ALTrainer


def _supervised_kwargs(kwargs: dict) -> dict:
    kwargs.setdefault("config", {})
    if isinstance(kwargs["config"], dict):
        kwargs["config"].setdefault("active_learning", False)
    return kwargs


class _SupervisedTrainer(ALTrainer):
    """The labeled set is fixed by a split: no selection at round start."""

    def _split_datasets(self, labeled: list, pool: list, valid: list):
        base = self.get_dataset("train")
        active_dataset = ActiveDataset(ExtendableDataset(base, list(labeled)),
                                       ExtendableDataset(base, list(pool)))
        valid_view = self.get_dataset("train")
        valid_dataset = ExtendableDataset(valid_view, list(valid))
        valid_dataset.CLASSES = getattr(valid_view, "CLASSES", {})
        valid_loader = BatchLoader(valid_dataset, batch_size=self.config.valid_batch_size,
                                   shuffle=False, drop_last=False)
        return base, base, valid_dataset, active_dataset, valid_loader

    def on_round_start(self):
        self._start_round_loader(self.work_path / f"round_{self.current_round}/data_list.json")
        # the counterpart of ``state.replace(step=0)``: the schedule restarts
        self.state.step = 0
        self.state.optimizer.count = 0


class UNetTrainer(_SupervisedTrainer):
    def __init__(
        self,
        *,
        num_folds: int = 5,
        valid_rate: float = 0.2,
        fold: int | str = "all",
        num_epochs: int | None = None,
        split_dicts: list | None = None,
        **kwargs,
    ):
        super().__init__(**_supervised_kwargs(kwargs))
        self.num_folds = num_folds
        self.valid_rate = valid_rate
        self.fold = fold
        self.num_epochs = num_epochs
        self.split_dicts = split_dicts

    # -- splits ---------------------------------------------------------
    def _get_split_dicts(self, case_names: list[str]) -> list[dict]:
        """Random cross-fold splits: each fold holds out a disjoint
        ``valid_rate`` block of one seeded permutation (wrapping around)."""
        if self.split_dicts is not None:
            return self.split_dicts
        rng = np.random.default_rng(self.seed)
        order = list(rng.permutation(case_names))
        n_valid = max(1, int(len(order) * self.valid_rate))
        splits = []
        for f in range(self.num_folds):
            lo = (f * n_valid) % len(order)
            valid = order[lo: lo + n_valid]
            if len(valid) < n_valid:  # wrap around
                valid = valid + order[: n_valid - len(valid)]
            train = [c for c in order if c not in set(valid)]
            splits.append({"train": train, "valid": valid})
        return splits

    @staticmethod
    def _assert_no_data_leak(split_dict: dict):
        """Train and valid must be disjoint."""
        overlap = set(split_dict["train"]) & set(split_dict["valid"])
        assert not overlap, f"data leak between train and valid: {overlap}"

    # -- per-fold data --------------------------------------------------
    def get_data(self):
        split = self._fold_split
        self._assert_no_data_leak(split)
        return self._split_datasets(split["train"], [], split["valid"])

    def on_round_start(self):
        super().on_round_start()
        self.logger.info(f"Fold {self._fold_index}: train "
                         f"{len(self.active_dataset.labeled_dataset)} / valid "
                         f"{len(self.valid_dataset)}")

    def run_training(self):
        base = self.get_dataset("train")
        splits = self._get_split_dicts(base.case_names())
        folds = range(self.num_folds) if self.fold == "all" else [int(self.fold)]
        root_work = self.work_path
        for f in folds:
            self._fold_index = f
            self._fold_split = splits[f]
            self.work_path = root_work / f"fold_{f}"
            self.work_path.mkdir(parents=True, exist_ok=True)
            if self.num_epochs is not None:
                iters_per_epoch = max(
                    len(self._fold_split["train"]) // self.config.batch_size, 1
                )
                self.config.num_iters = self.num_epochs * iters_per_epoch
            self._build_model(round_key=f)
            self.train()
            # alias the best checkpoint into the predict-ensemble layout
            best = self.work_path / "round_0/best_model/model.msgpack"
            if best.is_file():
                shutil.copyfile(best, self.work_path / "model.msgpack")
        self.work_path = root_work


class SemiTrainer(_SupervisedTrainer):
    """Labeled-ratio split scaffold; the training loop is supervised on the
    labeled split, like the reference."""

    def __init__(self, *, labeled_ratio: float = 0.1, valid_rate: float = 0.2, **kwargs):
        super().__init__(**_supervised_kwargs(kwargs))
        self.labeled_ratio = labeled_ratio
        self.valid_rate = valid_rate

    def get_random_split_dict(self, case_names: list[str]) -> dict:
        rng = np.random.default_rng(self.seed)
        order = list(rng.permutation(case_names))
        n_valid = max(1, int(len(order) * self.valid_rate))
        n_labeled = max(1, int((len(order) - n_valid) * self.labeled_ratio))
        return {
            "valid": order[:n_valid],
            "labeled": order[n_valid: n_valid + n_labeled],
            "unlabeled": order[n_valid + n_labeled:],
        }

    def get_data(self):
        split = self.get_random_split_dict(self.get_dataset("train").case_names())
        assert not (set(split["labeled"]) & set(split["valid"]))
        self.split_dict = split
        return self._split_datasets(split["labeled"], split["unlabeled"], split["valid"])
