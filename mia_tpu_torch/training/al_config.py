"""ALConfig: auto-capturing config object with JSON round-trip
(reference ``al_trainer.py:87-279``).

Every attribute assignment mirrors into ``_config_dict`` so the exact
configuration (including values mutated later, e.g. ``maximum_save_metric``)
serializes with ``save()``/``load()``.

Copied from ``mia_tpu/training/al_config.py`` (host-only; ``mia_tpu.training``
imports JAX).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any


class ALConfig:
    def __init__(
        self,
        seed: int = 12345,
        init_round_path: str | Path | None = None,
        init_data_list: str | Path | None = None,
        # Model parameters
        in_channels: int = 1,
        num_classes: int = 3,
        postprocess_mask: bool = False,
        block_type: str = "plain",
        block_normalization: str = "batch",
        dropout_prob: float = 0.1,
        deep_supervision: bool = False,
        ds_layer: int = 3,
        patch_size=None,
        image_size=None,
        model_ckpt: Path | str | None = None,
        compute_dtype: str = "float32",
        # Data parameters
        dataset: str = "ACDC",
        data_path: Path | str = "data",
        do_oversample: bool = False,
        do_augment: bool = False,
        do_normalize: bool = False,
        batch_size: int = 32,
        valid_batch_size: int = 1,
        num_workers: int = 1,
        pin_memory: bool = True,
        quantize_transfer: bool = False,
        # Training parameters
        active_learning: bool = True,
        num_rounds: int = 5,
        budget: int = 10,
        persist_model_weight: bool = False,
        active_selector_name: str = "random",
        coreset_criteria: str = "min",
        coreset_fusion: str = "add",
        kmean_sharp_factor: float = 1.0,
        kmean_softmax: bool = False,
        feature_path: Path | str | None = None,
        loaded_feature_weight: float = 0.0,
        loaded_feature_only: bool = False,
        optimizer_name: str = "adamw",
        optimizer_kwargs: dict | None = None,
        grad_norm: float = 10.0,
        min_iter: int = 0,
        num_iters: int = 4000,
        start_lr: float = 1e-3,
        lr_scheduler_name: str = "poly",
        lr_interval: int = 1,
        lr_warmup_iter: int = 5000,
        save_freq_epoch: int | None = None,
        valid_freq_iter: int = 200,
        log_every_iters: int = 1,
        warm_pool_cache: bool = True,
        valid_mode: str = "volumn",
        save_metric_name: str = "dice",
        maximum_save_metric: bool | None = None,
        loss_name: str = "dice+ce",
        dice_weight: float = 1.0,
        ce_weight: float = 1.0,
        early_stop_max_patience: int | None = None,
        # Inference parameters
        stride=None,
        # Misc parameters
        exp_name: str = "",
        **kwargs,
    ):
        self._config_dict = {}

        self.seed = seed
        self.init_round_path = init_round_path
        self.init_data_list = init_data_list

        self.in_channels = in_channels
        self.num_classes = num_classes
        self.postprocess_mask = postprocess_mask
        self.block_type = block_type
        self.block_normalization = block_normalization
        self.dropout_prob = dropout_prob
        self.deep_supervision = deep_supervision
        self.ds_layer = ds_layer
        def _pair(v):
            if v is None:
                return None
            if isinstance(v, int):
                return (v, v)
            v = tuple(v)
            return v * 2 if len(v) == 1 else v

        self.patch_size = _pair(patch_size)
        self.image_size = _pair(image_size)
        self.model_ckpt = model_ckpt
        self.compute_dtype = compute_dtype

        self.dataset = dataset
        self.data_path = data_path
        self.do_oversample = do_oversample
        self.do_augment = do_augment
        self.do_normalize = do_normalize
        self.batch_size = batch_size
        self.valid_batch_size = valid_batch_size
        self.num_workers = num_workers
        self.pin_memory = pin_memory
        self.quantize_transfer = quantize_transfer

        self.active_learning = active_learning
        if self.active_learning:
            self.num_rounds = num_rounds
            self.budget = budget
        else:
            self.num_rounds = 1
            self.budget = -1
        self.persist_model_weight = persist_model_weight

        self.active_selector_name = active_selector_name
        self.coreset_criteria = coreset_criteria
        self.coreset_fusion = coreset_fusion
        self.kmean_sharp_factor = kmean_sharp_factor
        self.kmean_softmax = kmean_softmax
        self.feature_path = feature_path
        self.loaded_feature_weight = loaded_feature_weight
        self.loaded_feature_only = loaded_feature_only
        self.optimizer_name = optimizer_name
        self.optimizer_kwargs = optimizer_kwargs or {}
        self.grad_norm = grad_norm
        self.num_iters = num_iters
        self.min_iter = min_iter
        self.start_lr = start_lr
        self.lr_scheduler_name = lr_scheduler_name
        self.lr_interval = lr_interval
        self.lr_warmup_iter = lr_warmup_iter
        self.save_freq_epoch = save_freq_epoch
        self.valid_freq_iter = valid_freq_iter
        # >1 defers the per-iteration loss D2H fetch (the one host sync in
        # the train loop) to every Nth step, so dispatch runs ahead of the
        # device; 1 keeps the reference's per-iteration log lines.
        self.log_every_iters = log_every_iters
        self.warm_pool_cache = warm_pool_cache
        self.valid_mode = valid_mode
        self.save_metric_name = save_metric_name
        self.maximum_save_metric = maximum_save_metric
        self.early_stop_max_patience = early_stop_max_patience
        self.loss_name = loss_name
        self.dice_weight = dice_weight
        self.ce_weight = ce_weight

        self.stride = stride
        self.exp_name = exp_name

    def __setattr__(self, name: str, value: Any) -> None:
        if hasattr(self, "_config_dict"):
            self._config_dict[name] = value
        super().__setattr__(name, value)

    def save(self, save_path: str | Path):
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        serializable = {
            k: (str(v) if isinstance(v, Path) else v)
            for k, v in self._config_dict.items()
        }
        with open(save_path, "w") as f:
            json.dump(serializable, f, indent=2)

    def load(self, save_path: str | Path) -> "ALConfig":
        with open(save_path) as f:
            data = json.load(f)
        for k, v in data.items():
            setattr(self, k, v)
        return self
