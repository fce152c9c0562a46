"""Round-based active-learning trainer in PyTorch — the ``al_train`` path.

Counterpart of ``mia_tpu/training/al_trainer.py`` with its default flags:
round loop with selector → extend → fresh weights → train → validate
(best weights kept in memory) → final/best checkpoints → test. Directory
layout ``work/round_i/{data_list.json, best_model/, iter_<n>_<metric>/,
final_model/}``, the JSON config snapshot, sanity overlays and CSV test
reports are the JAX package's. Checkpoints are the JAX package's files in
flax's layout: ``model.msgpack`` (``{"params", "batch_stats"}``) and, with
the training state, ``training_state.json`` and ``opt_state.msgpack`` (the
optax state). ``--model-ckpt`` and ``--init-round-path`` also read a
reference or port ``model.pth``/``.pt``; ``--resume`` reads a directory
written by either package.

Device work per train iteration: uint8 batch → augmentation (with kernel
K1) → z-score → UNet forward/backward → Dice+CE → clip → Adam, all eager
on ``device``. The eval pipeline (z-score → resize to the model size →
forward → argmax → resize back → per-class DSC/HD/ASD/JC) runs on the
device with the per-case resize matrices as data.

``--postprocess-mask`` denoises every predicted class map
(``models/processor.py``) before the metrics.

Every selector of the JAX package runs (``activelearning/selectors.py``),
on FUGC and BUSI. Not ported: wandb, mesh/multi-device, volume-mode
validation, the background pool-cache warmer.
"""

from __future__ import annotations

import csv
import functools
import json
import time
import warnings
from datetime import datetime
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from ..activelearning import SELECTORS, ModelScorer
from ..data import DATASETS, ActiveDataset, BatchLoader, ExtendableDataset, decode_path
from ..device import resolve_device, set_compute_precision
from ..losses import DiceAndCELoss
from ..metrics import metric_percase
from ..models import (UNet, UNetConfig, UnetProcessor, unet_state_dict_from_flax,
                      unet_state_dict_to_flax)
from ..models.torch_port import import_torch_unet_checkpoint
from ..ops.resize import _resize_matrix
from ..schedule import poly_warmup_schedule
from ..transforms import get_train_transform, zscore_normalize
from ..utils import add_file_sink, draw_mask, get_path, remove_sink, setup_logger
from ..utils.flax_msgpack import read_flax_msgpack, write_flax_msgpack
from .al_config import ALConfig
from .base_trainer import BaseTrainer
from .state import TrainState, load_optax_state, make_optimizer, to_optax_state
from .steps import make_train_step


@functools.lru_cache(maxsize=64)
def _eval_matrices(h: int, w: int, mh: int, mw: int):
    """Resize matrices native (h, w) ⇄ model (mh, mw) for the eval pipeline.

    Images: antialiased bilinear. Labels and predictions: nearest, built by
    querying PIL itself on an index image (PIL's boundary rounding differs
    from closed-form rules at exact .0 boundaries), so the device pipeline
    reproduces PIL's host resize bit for bit.
    """

    def pil_nearest_matrix(out_size, in_size):
        idx_img = np.arange(in_size, dtype=np.int32)[:, None]
        idx = np.asarray(
            Image.fromarray(idx_img, mode="I").resize((1, out_size), Image.NEAREST)
        )[:, 0]
        mat = np.zeros((out_size, in_size), np.float32)
        mat[np.arange(out_size), idx] = 1.0
        return mat

    return (
        _resize_matrix(mh, h, "bilinear", True),
        _resize_matrix(mw, w, "bilinear", True),
        pil_nearest_matrix(mh, h),
        pil_nearest_matrix(mw, w),
        pil_nearest_matrix(h, mh),
        pil_nearest_matrix(w, mw),
    )


class ALTrainer(BaseTrainer):
    DATASET_KEYS = {"fugc": "fugc", "busi": "busi"}

    def __init__(
        self,
        work_path: Path | str = Path.cwd(),
        deterministic: bool = True,
        device: str | torch.device = "cuda",
        config: ALConfig | dict | str | Path | None = None,
        resume: str | Path | None = None,
        verbose: bool = True,
        log_path: Path | str | None = None,
        config_path: Path | str | None = None,
        log_mode: str = "a",
        log_override: bool = False,
        use_wandb: bool = False,
        wandb_api_key: str | None = None,
        **kwargs,
    ):
        if isinstance(config, ALConfig):
            self.config = config
        elif isinstance(config, dict):
            self.config = ALConfig(**config)
        elif isinstance(config, (str, Path)):
            self.config = ALConfig().load(config)
        else:
            self.config = ALConfig()
        if use_wandb:
            raise NotImplementedError("--use-wandb is not ported")

        self.resume = resume
        self.device = resolve_device(device)
        set_compute_precision(self.config.compute_dtype)
        self.deterministic = deterministic
        self.work_path = get_path(work_path)
        self._set_seed(self.config.seed)

        self.current_epoch = 0
        self.current_round = 0
        self.current_iter = 0
        self.current_patience = 0

        self.verbose = verbose
        self.log_path = log_path
        self.config_path = config_path
        self.log_mode = log_mode
        self.log_override = log_override

        self.model = None
        self.state: TrainState | None = None
        self._best_state: dict | None = None
        self._scorer: ModelScorer | None = None

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------
    def initialize(self):
        self._set_snapshot_work_dir()
        self._setup_logger()
        self._build_model()

    def _set_seed(self, seed: int):
        self.seed = seed
        np.random.seed(seed)
        # augmentation and dropout draw from this generator, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)

    def _set_snapshot_work_dir(self):
        current_time_str = datetime.now().strftime("%Y%m%d_%H")
        c = self.config
        snapshot_list = [
            f"{c.dataset}",
            f"{current_time_str}",
            f"al-{c.active_learning}",
            f"round-{c.num_rounds}",
            f"budget-{c.budget}",
            f"selector-{c.active_selector_name}",
            f"patchsz-{c.patch_size}",
            f"imgsz-{c.image_size}",
            f"batchsz-{c.batch_size}",
            f"epoch-{c.num_iters}",
            f"optimizer-{c.optimizer_name}",
            f"lr-{c.lr_scheduler_name}",
            f"lrwarm-{c.lr_warmup_iter}",
            f"startlr-{c.start_lr}",
            f"dice-{c.dice_weight}",
            f"ce-{c.ce_weight}",
        ]
        if c.exp_name:
            snapshot_list.append(c.exp_name)
        self.work_path = self.work_path / "_".join(snapshot_list)
        self.work_path.mkdir(parents=True, exist_ok=True)

    def _setup_logger(self):
        if not self.log_path:
            self.log_path = self.work_path / "log.txt"
        self.logger = setup_logger(
            "MIA.ALTrainerTorch",
            log_path=self.log_path,
            verbose=self.verbose,
            log_mode=self.log_mode,
            log_override=self.log_override,
        )

    # ------------------------------------------------------------------
    # model
    # ------------------------------------------------------------------
    def _unet_config(self) -> UNetConfig:
        return UNetConfig(
            dimension=2,
            in_channels=self.config.in_channels,
            out_classes=self.config.num_classes + 1,
            channels_list=(32, 64, 128, 256, 512),
            block_type=self.config.block_type,
            normalization=self.config.block_normalization,
            dropout_prob=self.config.dropout_prob,
            deep_supervision=self.config.deep_supervision,
            ds_layer=self.config.ds_layer,
        )

    def _model_input_size(self) -> tuple[int, int]:
        if self.config.image_size is not None:
            return tuple(self.config.image_size)
        sample = self.get_dataset("train").get_sample(0)
        return tuple(sample["image"].shape[:2])

    def _build_model(self, round_key: int = 0):
        """Fresh weights for round ``round_key``, from a seed derived from
        the run seed and the round (the global RNG is left untouched)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed * 1009 + round_key)
            model = UNet(self._unet_config())
        model = model.to(self.device, memory_format=torch.channels_last)
        self.model_processor = UnetProcessor(image_size=self.config.image_size)
        self.lr_schedule = self._make_schedule()
        optimizer = make_optimizer(
            self.config.optimizer_name,
            model.parameters(),
            self.lr_schedule,
            grad_clip=self.config.grad_norm,
            **self.config.optimizer_kwargs,
        )
        self.model = model
        self.state = TrainState(model, optimizer)
        if self.config.model_ckpt:
            self.load_model_checkpoint(self.config.model_ckpt)

    def _make_schedule(self):
        if self.config.lr_scheduler_name == "poly":
            return poly_warmup_schedule(
                self.config.start_lr,
                max_steps=self.config.num_iters,
                warmup_steps=self.config.lr_warmup_iter,
                interval=self.config.lr_interval,
            )
        if self.config.lr_scheduler_name == "none":
            return lambda step: self.config.start_lr
        raise ValueError(
            f'Learning rate scheduler "{self.config.lr_scheduler_name}" not supported'
        )

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _snapshot(self) -> dict:
        return {k: v.detach().clone() for k, v in self.model.state_dict().items()}

    def _restore_best(self, ckpt: str | Path):
        """Restore the round's best weights from the in-memory snapshot, or
        from the checkpoint file when no validation improved this round."""
        if self._best_state is not None:
            self.model.load_state_dict(self._best_state)
            self.logger.info(f"Loaded model checkpoint from {ckpt} (in-memory)")
            return
        self.load_model_checkpoint(ckpt)

    def load_model_checkpoint(self, ckpt: str | Path):
        """Load a ``.pth``/``.pt`` state dict (the port's, or the reference
        UNet's), a flax ``model.msgpack``, or a directory holding either
        (``model.msgpack`` first, as the JAX package reads it)."""
        ckpt = Path(ckpt)
        if ckpt.is_dir():
            ckpt = next((ckpt / n for n in ("model.msgpack", "model.pth")
                         if (ckpt / n).is_file()), ckpt / "model.msgpack")
        try:
            if ckpt.suffix in (".pth", ".pt"):
                sd = torch.load(ckpt, map_location=self.device)
            else:
                sd = unet_state_dict_from_flax(read_flax_msgpack(ckpt))
            import_torch_unet_checkpoint(sd, self.model)
            self.logger.info(f"Loaded model checkpoint from {ckpt}")
        except Exception as e:  # the reference warns and trains on
            self.logger.warning(f"Failed to load model checkpoint from {ckpt}")
            self.logger.exception(e)

    def state_dict(self) -> dict:
        return {
            "current_iter": self.current_iter,
            "current_epoch": self.current_epoch,
            "current_round": self.current_round,
            "data_list": self.active_dataset.data_list(),
        }

    def load_state_dict(self, save_path: str | Path):
        """Resume from a checkpoint directory written with the training
        state: the model, the optimizer's moments and count, the counters
        (each offset by 1: a state is saved at the end of a step or round)
        and the data list."""
        save_path = get_path(save_path)
        self.load_model_checkpoint(save_path)
        ts_path = save_path / "training_state.json"
        if ts_path.is_file():
            ts = json.loads(ts_path.read_text())
            opt_path = save_path / "opt_state.msgpack"
            if opt_path.is_file():
                load_optax_state(self.state.optimizer, self.model, read_flax_msgpack(opt_path))
                self.state.step = ts["current_iter"] + 1
            self.current_epoch = ts["current_epoch"] + 1
            self.current_iter = ts["current_iter"] + 1
            self.current_round = ts["current_round"] + 1
            self.active_dataset.load_data_list(ts["data_list"])

    def save_state_dict(
        self,
        save_path: str | Path,
        save_training_state: bool = False,
        model_state: dict | None = None,
    ):
        save_path = get_path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        state = self.model.state_dict() if model_state is None else model_state
        write_flax_msgpack(unet_state_dict_to_flax(state), save_path / "model.msgpack")
        self.logger.info(f"Saved model checkpoint to {save_path / 'model.msgpack'}")
        if save_training_state:
            (save_path / "training_state.json").write_text(json.dumps(self.state_dict()))
            write_flax_msgpack(to_optax_state(self.state.optimizer, self.model),
                               save_path / "opt_state.msgpack")
        self.logger.info(f'Saved new checkpoint to "{save_path}"')

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def get_dataset(self, split: str):
        key = self.DATASET_KEYS.get(self.config.dataset)
        if key is None:
            raise NotImplementedError(f"the {self.config.dataset} dataset is not ported")
        image_size = self.config.image_size if split == "train" else None
        return DATASETS[key](
            data_path=self.config.data_path,
            split=split,
            image_channels=self.config.in_channels,
            image_size=image_size,
        )

    def get_data(self):
        labeled_base = self.get_dataset("train")
        pool_base = self.get_dataset("train")
        valid_dataset = self.get_dataset("valid")
        active_dataset = ActiveDataset(
            ExtendableDataset(labeled_base, []), ExtendableDataset(pool_base)
        )
        valid_loader = BatchLoader(
            valid_dataset,
            batch_size=self.config.valid_batch_size,
            shuffle=False,
            drop_last=False,
        )
        return labeled_base, pool_base, valid_dataset, active_dataset, valid_loader

    def get_train_dataloader(self, active_dataset: ActiveDataset):
        n_labeled = len(active_dataset.get_train_dataset())
        if 0 < n_labeled < self.config.batch_size and not self.config.do_oversample:
            # with drop_last the loader would yield ZERO batches and the
            # iteration-driven loop would spin through empty epochs forever
            raise ValueError(
                f"labeled set ({n_labeled}) is smaller than batch_size "
                f"({self.config.batch_size}) and drop_last would yield zero "
                "batches: pass --do-oversample (or lower --batch-size)"
            )
        return BatchLoader(
            active_dataset.get_train_dataset(),
            batch_size=self.config.batch_size,
            shuffle=True,
            drop_last=True,
            seed=self.seed + self.current_round,
            oversample=self.config.do_oversample,
            device=self.device,
        )

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _setup_loss(self):
        if self.config.loss_name != "dice+ce":
            raise ValueError(f"Loss function {self.config.loss_name} not found")
        self.supervised_loss = DiceAndCELoss(
            dice_weight=self.config.dice_weight,
            ce_weight=self.config.ce_weight,
            smooth=1e-5,
            do_bg=True,
            softmax=True,
            batch=False,
            squared=False,
        )

    def _setup_active_selector(self):
        name = self.config.active_selector_name
        if name not in SELECTORS:
            raise ValueError(f"ActiveSelector {name} not found")
        c = self.config
        # BADGE sweeps in chunks of up to 8 images (the reference forces 1 as a
        # memory workaround; the embedding of an image does not depend on its chunk)
        self.active_selector = SELECTORS[name](
            batch_size=c.batch_size if name != "badge" else max(1, min(8, c.batch_size)),
            coreset_criteria=c.coreset_criteria,
            coreset_fusion=c.coreset_fusion,
            feature_path=c.feature_path,
            loaded_feature_weight=c.loaded_feature_weight,
            loaded_feature_only=c.loaded_feature_only,
            sharp_factor=c.kmean_sharp_factor,
            softmax=c.kmean_softmax,
        )

    def _make_programs(self):
        self._recipe = get_train_transform(
            self.DATASET_KEYS[self.config.dataset], self.config.do_augment
        )
        self._aug_params_dict = self._recipe.get_params_dict()
        recipe = self._recipe
        do_normalize = self.config.do_normalize

        def preprocess(generator, images, labels):
            # the loader ships compact uint8; the float conversion runs here
            if images.dtype == torch.uint8:
                images = images.to(torch.float32) / 255.0
            else:
                images = images.to(torch.float32)
            labels = labels.long()
            if recipe.transforms:
                images, labels = recipe(generator, images, labels)
            if do_normalize:
                images = zscore_normalize(images)
            return images, labels

        self._train_step = make_train_step(self.supervised_loss, preprocess)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def on_train_start(self):
        (
            self.labeled_dataset,
            self.pool_dataset,
            self.valid_dataset,
            self.active_dataset,
            self.valid_dataloader,
        ) = self.get_data()

        self._setup_loss()
        self._setup_active_selector()
        self._make_programs()
        self.current_round = 0
        self._best_state = None

        if self.config.maximum_save_metric is None:
            if self.config.save_metric_name == "dice":
                self.config.maximum_save_metric = True
            elif self.config.save_metric_name in ("hd", "loss"):
                self.config.maximum_save_metric = False
            else:
                raise ValueError(
                    f"{self.config.save_metric_name} is not a valid save metric"
                )

        if self.resume is not None:
            self.load_state_dict(self.resume)

        self._print_train_info()
        self._check_data_sanity()

        if self.config.init_round_path:
            # round 0 comes from an earlier run: its best model and data list
            round_0 = get_path(self.config.init_round_path)
            for name in ("model.msgpack", "model.pth"):
                if (round_0 / "best_model" / name).is_file():
                    self.load_model_checkpoint(round_0 / "best_model" / name)
                    break
            self.active_dataset.load_data_list(round_0 / "data_list.json")
            self.perform_real_test()
            self.current_round = 1

    def _print_train_info(self):
        config_path = (
            get_path(self.config_path) if self.config_path else self.work_path / "config.txt"
        )
        sink = add_file_sink(self.logger, config_path, "w")
        self.logger.info("Training summary:")
        for k, v in self.config._config_dict.items():
            self.logger.info(f"  {k}: {v}")
        self.logger.info(f"  augmentation: {json.dumps(self._aug_params_dict, indent=2)}")
        name = (
            torch.cuda.get_device_name(self.device)
            if self.device.type == "cuda" else "cpu"
        )
        self.logger.info(f"  device: {self.device} ({name})")
        self.logger.info(f"  host decode: {decode_path()}")
        remove_sink(self.logger, sink)
        self.config.save(config_path.parent / f"{config_path.stem}.json")

    @torch.no_grad()
    def _check_data_sanity(self, num: int = 50):
        """Augmented overlay PNGs of 50 distinct pool samples."""
        ds = self.active_dataset.pool_dataset
        if len(ds) == 0:
            return
        sanity_path = self.work_path / "sanity"
        sanity_path.mkdir(parents=True, exist_ok=True)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed + 10_000)
        for i in range(num):
            sample = ds.get_sample(i % len(ds))
            img = torch.from_numpy(sample["image"]).to(self.device)[None]
            lbl = torch.from_numpy(sample["label"]).to(self.device).long()[None]
            img, lbl = self._recipe(gen, img, lbl)
            overlay = draw_mask(img[0].cpu().numpy(), lbl[0].cpu().numpy())
            Image.fromarray(overlay).save(sanity_path / f"{i + 1}.png")

    def on_round_start(self):
        data_list_path = self.work_path / f"round_{self.current_round}/data_list.json"
        # with --init-round-path, round 1 starts from the loaded round-0 model
        from_previous_round = self.current_round > 1 or (
            self.current_round == 1 and self.config.init_round_path is None
        )

        if from_previous_round:
            self._restore_best(self.work_path / f"round_{self.current_round - 1}/best_model")

        if self.config.active_learning:
            if self.current_round == 0 and self.config.init_data_list:
                self.active_dataset.load_data_list(self.config.init_data_list)
            else:
                if self._scorer is None:
                    self._scorer = ModelScorer(
                        self.model, self.device, normalize=self.config.do_normalize
                    )
                self._scorer.model = self.model
                new_samples = self.active_selector.select_next_batch(
                    self.active_dataset,
                    self.config.budget,
                    self._scorer,
                    seed=self.seed + self.current_round,
                )
                self.active_dataset.extend_train_set(new_samples)
        else:
            self.active_dataset.extend_train_set(
                list(self.active_dataset.pool_dataset.image_idx)
            )

        # fresh weights per round unless persisted
        if self.current_round > 0:
            self._build_model(round_key=self.current_round)
            if self.config.persist_model_weight and from_previous_round:
                self._restore_best(
                    self.work_path / f"round_{self.current_round - 1}/best_model"
                )

        self._start_round_loader(data_list_path)

        labeled_size, pool_size = self.active_dataset.get_size()
        self.logger.info("")
        self.logger.info(f"Round {self.current_round}:")
        self.logger.info(f"Labeled size: {labeled_size}")
        self.logger.info(f"Pool size: {pool_size}")

    def _start_round_loader(self, data_list_path: Path):
        """Write the round's data list, build its train loader and reset the
        round's counters and best metric."""
        self.active_dataset.save_data_list(data_list_path)
        self.train_dataloader = self.get_train_dataloader(self.active_dataset)

        self.current_epoch = 0
        self.current_iter = 0
        self.current_patience = 0

        default = -np.inf if self.config.maximum_save_metric else np.inf
        self._best_valid_metric = default
        self._cur_valid_metric = default
        self._best_state = None  # this round's best lives here

    def on_round_end(self):
        self.save_state_dict(
            self.work_path / f"round_{self.current_round}/final_model", True
        )
        self._restore_best(self.work_path / f"round_{self.current_round}/best_model")
        self.perform_real_test()
        self.logger.info("")
        self.current_round += 1

    def on_epoch_start(self):
        self._epoch_start_time = time.time()
        self.logger.info("")
        self.logger.info(f"Epoch {self.current_epoch}:")

    def on_epoch_end(self):
        self.current_epoch += 1
        self.logger.info(f"Epoch time elapsed: {time.time() - self._epoch_start_time:.3f} seconds")
        for h in self.logger.handlers:
            h.flush()

    def on_train_epoch_start(self):
        self._train_start_time = time.time()
        self.logger.info("Train")
        self.epoch_train_outputs = []
        self._pending_train_logs = []

    def _record_train_loss(self, step_index: int, lr: float, loss: float):
        self.epoch_train_outputs.append({"loss": loss})

    def _emit_train_log(self, pending):
        step_index, lr, loss, ready = pending
        if ready is not None:
            ready.synchronize()
        loss = float(loss)
        self.logger.info(f"Iteration {step_index} lr: {lr} Loss: {loss}")
        self._record_train_loss(step_index, lr, loss)

    def _flush_train_logs(self):
        pending, self._pending_train_logs = getattr(self, "_pending_train_logs", []), []
        for p in pending:
            self._emit_train_log(p)

    def on_train_epoch_end(self):
        self._flush_train_logs()
        if (
            self.config.save_freq_epoch
            and (self.current_epoch + 1) % self.config.save_freq_epoch == 0
        ):
            self.save_state_dict(
                self.work_path / f"round_{self.current_round}/epoch_{self.current_epoch}",
                True,
            )
        if self.epoch_train_outputs:
            train_loss = float(np.mean([o["loss"] for o in self.epoch_train_outputs]))
            self.logger.info(f"Loss ({self.config.loss_name}): {train_loss}")
        self.logger.info(f"Train time elapsed: {time.time() - self._train_start_time:.3f} seconds")

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def train_step(self, sampled_batch):
        start = time.time()
        self.logger.info(f"Iteration {self.current_iter}:")
        step_index = self.current_iter
        metrics = self._train_step(
            self.state, sampled_batch["image"], sampled_batch["label"], self.generator
        )
        lr = float(self.lr_schedule(step_index))
        # start the loss's device→host copy now and read it one iteration
        # later, so the host queues the next step while this one runs
        loss, ready = metrics["loss"], None
        if loss.device.type == "cuda":
            loss = loss.to("cpu", non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        self._pending_train_logs.append((step_index, lr, loss, ready))
        log_every = max(1, int(self.config.log_every_iters))
        if log_every <= 1:
            if len(self._pending_train_logs) > 1:
                self._emit_train_log(self._pending_train_logs.pop(0))
        elif (step_index + 1) % log_every == 0:
            self._flush_train_logs()
        self.logger.info(f"Iteration time elapsed: {time.time() - start:.3f} seconds")
        self.logger.info("")
        self.current_iter += 1

    @torch.no_grad()
    def _eval_batch(self, sampled_batch):
        """Evaluate one host batch of 2D slices on the device.

        z-score over each slice at native resolution → resize to the model
        size → forward → argmax → nearest resize back → per-slice metrics.
        Returns ``metric_all (n, 4)``, ``per_cls (n, C, 4)`` as device
        tensors and the mean per-slice loss as a device scalar.
        """
        images = np.asarray(sampled_batch["image"])
        if images.ndim == 5:
            raise NotImplementedError("volume-mode validation is not ported")
        dev = self.device
        x = torch.from_numpy(images).to(dev)
        x = x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x.to(torch.float32)
        labels = torch.from_numpy(np.asarray(sampled_batch["label"], np.int64)).to(dev)
        n, h, w = labels.shape
        mh, mw = self._model_input_size()
        m_img_h, m_img_w, m_lbl_h, m_lbl_w, m_back_h, m_back_w = (
            torch.from_numpy(m).to(dev) for m in _eval_matrices(h, w, mh, mw)
        )

        if self.config.do_normalize:
            # Bessel-corrected std over each slice, clipped at 1e-8
            cnt = float(h * w * x.shape[-1])
            mean = x.sum((1, 2, 3), keepdim=True) / cnt
            sq = x.square().sum((1, 2, 3), keepdim=True)
            var = (sq - cnt * mean.square()) / max(cnt - 1.0, 1.0)
            x = (x - mean) / var.clamp_min(0.0).sqrt().clamp_min(1e-8)
        x = torch.einsum("oh,nhwc->nowc", m_img_h, x)
        x = torch.einsum("ow,nhwc->nhoc", m_img_w, x).contiguous()
        lbl_m = torch.einsum("oh,nhw->now", m_lbl_h, labels.to(torch.float32))
        lbl_m = torch.einsum("ow,nhw->nho", m_lbl_w, lbl_m).long()

        self.model.eval()
        logits = self.model(x)
        pred = torch.softmax(logits.to(torch.float32), -1).argmax(-1)
        loss = torch.stack(
            [self.supervised_loss(logits[i : i + 1], lbl_m[i : i + 1])[0] for i in range(n)]
        ).mean()
        pred_nat = torch.einsum("oh,nhw->now", m_back_h, pred.to(torch.float32))
        pred_nat = torch.einsum("ow,nhw->nho", m_back_w, pred_nat).to(torch.uint8)
        if self.config.postprocess_mask:
            pred_nat = self.model_processor.denoise_one_mask(pred_nat)

        spacing = sampled_batch.get("spacing")
        if spacing is not None and spacing[0] is not None:
            sp = np.roll(np.asarray(spacing[0], np.float32), 1)
            sp = tuple(np.concatenate([[1.0], sp]) if sp.size == 2 else sp)
        else:
            sp = (1.0, 1.0, 1.0)
        metric_all, per_cls = [], []
        for p, g in zip(pred_nat, labels):
            p, g = p[None], g[None]  # a slice is a depth-1 volume
            metric_all.append(torch.stack(metric_percase(p > 0, g > 0, sp)))
            per_cls.append(torch.stack([
                torch.stack(metric_percase(p == c, g == c, sp))
                for c in range(1, self.config.num_classes + 1)
            ]))
        return torch.stack(metric_all), torch.stack(per_cls), loss

    @staticmethod
    def _finalize_eval(metric_all, per_cls, loss):
        return metric_all.cpu().numpy(), per_cls.cpu().numpy(), float(loss)

    def valid_step(self, sampled_batch):
        self.epoch_valid_outputs.append(self._eval_batch(sampled_batch))

    def on_valid_epoch_start(self):
        self._flush_train_logs()
        self._valid_start_time = time.time()
        self.logger.info("Valid")
        self.epoch_valid_outputs = []

    @staticmethod
    def _is_improved(old_metric, new_metric, maximum):
        return old_metric < new_metric if maximum else old_metric > new_metric

    def on_valid_epoch_end(self):
        outs = [
            dict(zip(("metric_all", "metric", "loss"), self._finalize_eval(*o)))
            for o in self.epoch_valid_outputs
        ]
        self.epoch_valid_outputs = outs
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            avg_metric_all = np.nanmean(np.concatenate([o["metric_all"] for o in outs]), 0)
            avg_metric_per_cls = np.nanmean(np.concatenate([o["metric"] for o in outs]), 0)
            loss = float(np.nanmean([o["loss"] for o in outs]))
            avg_dsc = float(np.mean(avg_metric_per_cls[:, 0]))
            avg_hd = float(np.nanmean(avg_metric_per_cls[:, 1]))

        classes = self.valid_dataset.CLASSES
        self.logger.info("Valid results (DSC, HD, ASD, JSD):")
        for cid in classes:
            if cid == 0:
                self.logger.info(f"  all: {avg_metric_all.tolist()}")
            else:
                self.logger.info(f"  {classes[cid]}: {avg_metric_per_cls[cid - 1].tolist()}")
        self.logger.info(f"Average: {np.nanmean(avg_metric_per_cls, 0).tolist()}")
        self.logger.info(f"loss: {loss}")

        if self.config.save_metric_name == "dice":
            self._cur_valid_metric = avg_dsc
        elif self.config.save_metric_name == "hd":
            self._cur_valid_metric = avg_hd
        elif self.config.save_metric_name == "loss":
            self._cur_valid_metric = loss

        if self._is_improved(
            self._best_valid_metric, self._cur_valid_metric, self.config.maximum_save_metric
        ):
            self._best_valid_metric = self._cur_valid_metric
            self.logger.info(
                f"New best metric ({self.config.save_metric_name}): {self._cur_valid_metric}"
            )
            # best weights stay in memory: round end and the next round's
            # selection restore from here instead of re-reading the file
            self._best_state = self._snapshot()
            self.save_state_dict(
                self.work_path / f"round_{self.current_round}/best_model",
                model_state=self._best_state,
            )
            self.save_state_dict(
                self.work_path
                / f"round_{self.current_round}/iter_{self.current_iter}_{self._best_valid_metric:.4f}",
                model_state=self._best_state,
            )
            self.current_patience = 0
        else:
            self.current_patience += 1

        self.logger.info(f"current_patience: {self.current_patience}")
        self.logger.info(f"Valid time elapsed: {time.time() - self._valid_start_time:.3f} seconds")

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def train(self):
        self.on_train_start()
        while self.current_round < self.config.num_rounds:
            self.on_round_start()
            while not self.is_finished():
                self.on_epoch_start()
                self.on_train_epoch_start()
                for sampled_batch in self.train_dataloader:
                    if self.is_finished():
                        break
                    self.train_step(sampled_batch)
                    self.valid()
                self.on_train_epoch_end()
                self.on_epoch_end()
            self.on_round_end()
        self.on_train_end()

    def valid(self):
        if self.current_iter % self.config.valid_freq_iter == 0:
            self.on_valid_epoch_start()
            for sampled_batch in self.valid_dataloader:
                self.valid_step(sampled_batch)
            self.on_valid_epoch_end()

    def is_finished(self):
        if self.current_iter < self.config.min_iter:
            return False
        if (
            self.config.early_stop_max_patience
            and self.current_patience >= self.config.early_stop_max_patience
        ):
            self.logger.info("Exceeded maximum patience. Training will be early stopped")
            return True
        return self.current_iter >= self.config.num_iters

    def run_training(self):
        self.train()

    # ------------------------------------------------------------------
    # test
    # ------------------------------------------------------------------
    def perform_real_test(self):
        if not hasattr(self, "supervised_loss"):
            # --test-only: build the loss without training
            self._setup_loss()
        if not hasattr(self, "valid_dataset"):
            self.valid_dataset = self.get_dataset("valid")
        test_dataset = self.get_dataset("test")
        test_loader = BatchLoader(
            test_dataset,
            batch_size=self.config.valid_batch_size,
            shuffle=False,
            drop_last=False,
        )
        metric_all_list, metric_list = [], []
        for batch in test_loader:
            metric_all, metric, _ = self._finalize_eval(*self._eval_batch(batch))
            metric_all_list.extend(metric_all)
            metric_list.extend(metric)

        metric_all_arr = np.asarray(metric_all_list)  # (N, 4)
        metric_arr = np.asarray(metric_list)  # (N, C, 4)
        classes = test_dataset.CLASSES
        metric_name = {0: "DSC", 1: "HD", 2: "ASD", 3: "JSD"}
        dataframe_dict = {}
        for class_id in classes:
            for metric_id, mname in metric_name.items():
                if class_id == 0:
                    dataframe_dict[f"all-{mname}"] = metric_all_arr[:, metric_id].tolist()
                else:
                    dataframe_dict[f"{classes[class_id]}-{mname}"] = metric_arr[
                        :, class_id - 1, metric_id
                    ].tolist()

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            avg_metric_all = np.nanmean(metric_all_arr, 0)
            avg_metric_per_cls = np.nanmean(metric_arr, 0)
            overall = np.nanmean(avg_metric_per_cls, 0)

        self.logger.info("Real test results (DSC, HD, ASD, JSD):")
        for cid in classes:
            if cid == 0:
                self.logger.info(f"  all: {avg_metric_all.tolist()}")
            else:
                self.logger.info(f"  {classes[cid]}: {avg_metric_per_cls[cid - 1].tolist()}")
        self.logger.info(f"Average: {overall.tolist()}")

        write_csv = self.work_path / f"test_mean_round_{self.current_round}.csv"
        with open(write_csv, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(list(dataframe_dict.keys()))
            writer.writerows(zip(*dataframe_dict.values()))

        return {
            "dsc": float(overall[0]),
            "hd": float(overall[1]),
            "asd": float(overall[2]),
            "jc": float(overall[3]),
        }
