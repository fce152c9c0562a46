"""Semi-supervised Cross-Prompting-Consistency SAM trainer in PyTorch — the
``cpcsam_train`` path.

Counterpart of ``mia_tpu/training/cpcsam_trainer.py`` with its default
flags: a LoRA-tuned ``SamDualmask`` trained eagerly on ``device``,

- phase 1 (``iter < warmup_iter``): the encoder and the unprompted
  decoders on the labeled slice of the batch only, loss1 = Σ_decoders
  ``(1-w)·CE + w·Dice``;
- phase 2: the same loss1 pass, plus one batched prompt generation for all
  decoders (each decoder's pseudo-label is the mean softmax of the others,
  ``prompt_generation.py`` with K5) and, per decoder, a prompted pass in
  one 2B batch (center/fit and random/loose prompts); loss2 = supervised
  terms of both prompted outputs + consistency of the other decoders
  (weight ``coe1``) and of the random/loose output (``coe2``) with the
  pseudo-label of the prompted pair, at dice weight 0.5;
- Adam over the trainable parameters only (LoRA adapters and everything
  outside the encoder), no clip, poly-warmup LR.

Eager PyTorch has no common-subexpression elimination: the JAX package's
three phase-2 prompted passes each run the unprompted decoder stack and
XLA merges them into one. Here that stack runs once per phase-2 step and
serves the three passes and the raw softmaxes of the prompt generation
(the gradients of its three uses add up, as those of the three copies do).

With an auxiliary loss on, both phases run on the whole batch (nothing is
sliced in phase 1), as in the JAX package:

- ``use_contrastive_loss``: every decoder's dense features (of the
  unprompted pass and, in phase 2, of the three prompted ones), labeled and
  unlabeled apart, go through the projection and prediction heads; the
  correct labeled predictions refresh the feature memory (trainer state,
  no gradient), and loss3 = ``contrastive_weight`` · (labeled term with the
  labels + unlabeled term with the predictions) of
  ``losses/contrastive.py``. The heads run on every pixel of every group
  (millions of rows): they are recomputed in the backward
  (``torch.utils.checkpoint``) instead of keeping their activations.
- ``use_adv_loss``: loss3 += ``adv_weight`` · VAT (``losses/vat.py``) on
  the image embeddings through the unprompted decoders.

Checkpoints: the LoRA checkpoint ``lora.msgpack`` (adapters + everything
outside the frozen encoder, the JAX package's file in flax's layout; a torch
``lora.pth`` is read too) and, with ``save_training_state``,
``training_state.json`` (iter, epoch: the JAX package's file) and the port's
``training_state.pth`` (optimizer state, feature memory, the generator's
and numpy's RNG state). ``resume`` loads all of them and goes on at the
next epoch, so that a run saved at an epoch's end and resumed takes the
steps the uninterrupted run takes. A directory without
``training_state.pth`` (the JAX package writes none) resumes with a fresh
optimizer, as the JAX package resumes. Both packages save
``current_iter`` after its increment, as the count of steps taken; the port
resumes at that count, the JAX package one later (it adds 1 on load). Validation, the real test and
the CSV report are the JAX package's. Not ported: wandb, bfloat16 compute,
mesh/multi-device.
"""

from __future__ import annotations

import csv
import json
import time
import warnings
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..data import ACDCDataset, BatchLoader, TwoStreamBatchSampler
from ..device import resolve_device, set_compute_precision
from ..losses import DiceAndCELoss, prototype_contrastive_loss, vat_loss
from ..memories import FeatureMemoryState, init_feature_memory, update_feature_memory
from ..models.sam.build_sam import import_torch_sam_encoder, sam_model_registry
from ..models.sam.lora import (freeze_wrt_mask, load_lora_state_dict, lora_trainable_mask,
                               read_lora_checkpoint, write_lora_msgpack)
from ..models.sam.prompt_generation import prompt_generate_random_fast
from ..models.sam.sam import postprocess_masks
from ..models.sam.validation import test_single_volume, test_single_volume_mean
from ..schedule import poly_warmup_schedule, sigmoid_ramp_up
from ..utils import get_path, setup_logger
from .base_trainer import BaseTrainer
from .state import make_optimizer


class CPCSAMConfig:
    """Auto-capturing config (copied from the JAX package's ``CPCSAMConfig``)."""

    def __init__(
        self,
        seed: int = 12345,
        # Model parameters
        in_channels: int = 3,
        num_classes: int = 3,
        patch_size=None,
        image_size=512,
        sam_name: str = "vit_b_dualmask_same_prompt_class_random_large",
        model_ckpt=None,
        lora_rank: int = 4,
        lora_ckpt=None,
        promptmode=("point",),
        dropout_rate: float = 0.0,
        num_points_prompt=(1, 2),
        bbox_change_rate=(0.1, 0.2),
        prompt_compute_size: int = 64,
        compute_dtype: str = "float32",
        # Data parameters
        dataset: str = "ACDC",
        data_path="data",
        labeled_ratio: float = 1.0,
        labeled_num: int | None = 1,
        do_augment: bool = False,
        do_normalize: bool = False,
        batch_size: int = 32,
        labeled_batch_ratio: float = 0.5,
        num_workers: int = 1,
        pin_memory: bool = True,
        # Training parameters
        optimizer_name: str = "adamw",
        optimizer_kwargs: dict | None = None,
        num_epochs: int = 10000,
        min_iter: int = 10000,
        max_iter: int | None = None,
        warmup_iter: int = 5000,
        start_lr: float = 1e-3,
        lr_scheduler_name: str = "poly",
        lr_warmup_iter: int = 5000,
        save_freq_epoch: int = 100,
        valid_freq_iter: int = 200,
        log_every_iters: int = 1,
        save_metric_name: str = "dice",
        maximum_save_metric: bool | None = None,
        loss_name: str = "dice+ce",
        dice_weight: float = 0.8,
        loss2_weight: float = 1.0,
        loss2_weight_rampup_interval: int = 100,
        loss2_weight_rampup_iter: int = 0,
        consistency_weight_1: float = 0.4,
        consistency_weight_2: float = 0.05,
        early_stop_max_patience: int | None = None,
        loss3_weight: float = 0.1,
        loss3_weight_rampup_interval: int = 100,
        loss3_weight_rampup_iter: int = 15000,
        use_contrastive_loss: bool = False,
        contrastive_dropout_rate: float = 0.0,
        contrastive_weight: float = 0.1,
        use_adv_loss: bool = False,
        adv_weight: float = 1.0,
        adv_loss_kwargs: dict | None = None,
        phase1_labeled_only: bool = True,
        stride=None,
        exp_name: str = "",
        **kwargs,
    ):
        self._config_dict = {}
        self.seed = seed
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.patch_size = patch_size
        self.image_size = image_size if not isinstance(image_size, (list, tuple)) else image_size[0]
        self.sam_name = sam_name
        self.model_ckpt = model_ckpt
        self.lora_rank = lora_rank
        self.lora_ckpt = lora_ckpt
        self.promptmode = list(promptmode)
        self.dropout_rate = dropout_rate
        self.num_points_prompt = tuple(num_points_prompt)
        self.bbox_change_rate = tuple(bbox_change_rate)
        # resolution of the phase-2 CC/EDT prompt machinery (0: native)
        self.prompt_compute_size = prompt_compute_size
        self.compute_dtype = compute_dtype

        self.dataset = dataset
        self.data_path = data_path
        self.labeled_ratio = labeled_ratio
        self.labeled_num = labeled_num
        self.do_augment = do_augment
        self.do_normalize = do_normalize
        self.batch_size = batch_size
        self.labeled_batch_size = round(batch_size * labeled_batch_ratio)
        self.num_workers = num_workers
        self.pin_memory = pin_memory

        self.optimizer_name = optimizer_name
        self.optimizer_kwargs = optimizer_kwargs or {}
        self.num_epochs = num_epochs
        self.min_iter = min_iter
        self.max_iter = max_iter if max_iter is not None else min_iter
        self.warmup_iter = warmup_iter
        self.start_lr = start_lr
        self.lr_scheduler_name = lr_scheduler_name
        self.lr_warmup_iter = lr_warmup_iter
        self.save_freq_epoch = save_freq_epoch
        self.valid_freq_iter = valid_freq_iter
        self.log_every_iters = log_every_iters
        self.save_metric_name = save_metric_name
        self.maximum_save_metric = maximum_save_metric
        self.loss_name = loss_name
        self.dice_weight = dice_weight
        self.loss2_weight = loss2_weight
        self.loss2_weight_rampup_interval = loss2_weight_rampup_interval
        self.loss2_weight_rampup_iter = loss2_weight_rampup_iter
        self.consistency_weight_1 = consistency_weight_1
        self.consistency_weight_2 = consistency_weight_2
        self.early_stop_max_patience = early_stop_max_patience
        self.loss3_weight = loss3_weight
        self.loss3_weight_rampup_interval = loss3_weight_rampup_interval
        self.loss3_weight_rampup_iter = loss3_weight_rampup_iter
        self.use_contrastive_loss = use_contrastive_loss
        self.contrastive_dropout_rate = contrastive_dropout_rate
        self.contrastive_weight = contrastive_weight
        self.use_adv_loss = use_adv_loss
        self.adv_weight = adv_weight
        self.adv_loss_kwargs = adv_loss_kwargs or {"xi": 10.0, "epi": 6.0, "ip": 1}
        self.phase1_labeled_only = phase1_labeled_only
        self.stride = stride
        self.exp_name = exp_name

    def __setattr__(self, name, value):
        if hasattr(self, "_config_dict"):
            self._config_dict[name] = value
        super().__setattr__(name, value)

    def save(self, save_path):
        save_path = Path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        serializable = {k: (str(v) if isinstance(v, Path) else v)
                        for k, v in self._config_dict.items()}
        save_path.write_text(json.dumps(serializable, indent=2))

    def load(self, save_path):
        for k, v in json.loads(Path(save_path).read_text()).items():
            setattr(self, k, v)
        return self


# ACDC labeled-patients → slice-count table of the reference
PATIENTS_TO_SLICES = {
    "ACDC": {"1": 32, "3": 68, "7": 136, "14": 256, "21": 396, "28": 512, "35": 664, "140": 1312}
}


def patients_to_slices(dataset: str, patients_num) -> int:
    return PATIENTS_TO_SLICES[dataset][str(patients_num)]


class CPCSAMTrainer(BaseTrainer):
    def __init__(
        self,
        work_path=Path.cwd(),
        device: str | torch.device = "cuda",
        config=None,
        resume=None,
        verbose: bool = True,
        log_path=None,
        config_path=None,
        log_mode="a",
        log_override=False,
        use_wandb=False,
        wandb_api_key=None,
        **kwargs,
    ):
        if isinstance(config, CPCSAMConfig):
            self.config = config
        elif isinstance(config, dict):
            self.config = CPCSAMConfig(**config)
        elif isinstance(config, (str, Path)):
            self.config = CPCSAMConfig().load(config)
        else:
            self.config = CPCSAMConfig()
        if use_wandb:
            raise NotImplementedError("--use-wandb is not ported")
        self.resume = resume

        self.device = resolve_device(device)
        if self.config.compute_dtype == "bfloat16":
            raise NotImplementedError(
                "cpcsam_train with --compute-dtype bfloat16 needs the bfloat16 backward kernels "
                "K2b, K3b and K4b, which are not ported; use --compute-dtype float32")
        set_compute_precision(self.config.compute_dtype)
        self.work_path = get_path(work_path)
        self.verbose = verbose
        self.log_path = log_path
        self.config_path = config_path
        self.log_mode = log_mode
        self.log_override = log_override
        np.random.seed(self.config.seed)
        # prompt draws and embedding dropout, on the device
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.config.seed)

        self.current_iter = 0
        self.current_epoch = 0
        self.current_patience = 0
        self.model = None
        self.memory = None
        self._pending_train_logs = []

    # ------------------------------------------------------------------
    def initialize(self):
        stamp = datetime.now().strftime("%Y%m%d_%H")
        c = self.config
        name = "_".join(
            ["cpcsam", f"{c.dataset}", stamp, f"labeled-{c.labeled_num}", f"imgsz-{c.image_size}",
             f"batchsz-{c.batch_size}", f"lora-{c.lora_rank}", f"prompt-{'-'.join(c.promptmode)}"]
            + ([c.exp_name] if c.exp_name else [])
        )
        self.work_path = self.work_path / name
        self.work_path.mkdir(parents=True, exist_ok=True)
        if not self.log_path:
            self.log_path = self.work_path / "log.txt"
        self.logger = setup_logger("MIA.CPCSAMTrainerTorch", log_path=self.log_path,
                                   verbose=self.verbose, log_mode=self.log_mode,
                                   log_override=self.log_override)
        self._build_model()

    def _build_model(self):
        """Weights from a seed derived from the run seed (the global RNG is
        left untouched), then the checkpoints, on ``device``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.config.seed)
            self.model, self.embed_size = sam_model_registry[self.config.sam_name](
                image_size=self.config.image_size,
                num_classes=self.config.num_classes,
                lora_rank=self.config.lora_rank,
                dropout_rate=self.config.dropout_rate,
                num_points_prompt=self.config.num_points_prompt,
                bbox_change_rate=self.config.bbox_change_rate,
            )
        self.model.to(self.device)
        if self.config.model_ckpt:
            self.load_model_checkpoint(self.config.model_ckpt)
        if self.config.lora_ckpt:
            self.load_lora_checkpoint(self.config.lora_ckpt)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def load_model_checkpoint(self, ckpt):
        """A reference SAM checkpoint (``.pth``/``.pt``): its encoder, after
        the ``load_from`` surgery, replaces the encoder's weights; the LoRA
        adapters stay. A directory: a whole-model ``model.pth``."""
        ckpt = Path(ckpt)
        try:
            if ckpt.is_dir():
                ckpt = ckpt / "model.pth"
                self.model.load_state_dict(torch.load(ckpt, map_location=self.device))
            else:
                sd = torch.load(ckpt, map_location="cpu")
                enc = import_torch_sam_encoder(
                    sd, depth=self.model.encoder_depth, image_size=self.config.image_size,
                    global_attn_indexes=self.model.encoder_global_attn_indexes)
                missing, unexpected = self.model.image_encoder.load_state_dict(enc, strict=False)
                if unexpected or any("lora_" not in k for k in missing):
                    raise KeyError(f"encoder mismatch: missing {missing[:5]}, "
                                   f"unexpected {unexpected[:5]}")
            self.logger.info(f"Loaded model checkpoint from {ckpt}")
        except Exception as e:  # the reference warns and trains on
            self.logger.warning(f"Failed to load model checkpoint from {ckpt}")
            self.logger.exception(e)

    def load_lora_checkpoint(self, ckpt):
        try:
            load_lora_state_dict(self.model, read_lora_checkpoint(ckpt))
            self.logger.info(f"Loaded LoRA checkpoint from {ckpt}")
        except Exception as e:
            self.logger.warning(f"Failed to load LoRA checkpoint from {ckpt}")
            self.logger.exception(e)

    def save_state_dict(self, save_path, save_training_state: bool = False):
        save_path = get_path(save_path)
        save_path.mkdir(parents=True, exist_ok=True)
        write_lora_msgpack(self.model, save_path / "lora.msgpack")
        if save_training_state:
            (save_path / "training_state.json").write_text(json.dumps(self.state_dict()))
            torch.save({"optimizer": self.optimizer.state_dict(),
                        "memory": None if self.memory is None else tuple(self.memory),
                        "generator": self.generator.get_state(),
                        "numpy_rng": np.random.get_state()},
                       save_path / "training_state.pth")
        self.logger.info(f'Saved new checkpoint to "{save_path}"')

    def load_state_dict(self, save_path):
        """Resume from a checkpoint directory written with
        ``save_training_state``: the LoRA checkpoint, the optimizer state,
        the feature memory and the generators; training goes on at the saved
        iteration, in the epoch after the saved one (checkpoints are written
        at an epoch's end). Call after the optimizer is set up."""
        save_path = get_path(save_path)
        lora = next((save_path / n for n in ("lora.msgpack", "lora.pth")
                     if (save_path / n).is_file()), None)
        if lora is not None:
            self.load_lora_checkpoint(lora)
        if (save_path / "training_state.json").is_file():
            state = json.loads((save_path / "training_state.json").read_text())
            self.current_iter = state["current_iter"]
            self.current_epoch = state["current_epoch"] + 1
        if (save_path / "training_state.pth").is_file():
            state = torch.load(save_path / "training_state.pth", map_location=self.device,
                               weights_only=False)
            self.optimizer.load_state_dict(state["optimizer"])
            if state["memory"] is not None:
                self.memory = FeatureMemoryState(*state["memory"])
            self.generator.set_state(state["generator"].cpu())
            np.random.set_state(state["numpy_rng"])
        self.logger.info(f'Resumed from "{save_path}" at iteration {self.current_iter}, '
                         f"epoch {self.current_epoch}")

    def state_dict(self):
        return {"current_iter": self.current_iter, "current_epoch": self.current_epoch}

    # ------------------------------------------------------------------
    # data
    # ------------------------------------------------------------------
    def _make_dataset(self, split: str):
        """The one place a dataset is built (train, valid and test)."""
        if self.config.dataset != "ACDC":
            raise NotImplementedError(f"the {self.config.dataset} dataset is not ported")
        return ACDCDataset(data_path=self.config.data_path, split=split,
                           image_channels=self.config.in_channels)

    def get_data(self):
        train_dataset = self._make_dataset("train")
        total_slices = len(train_dataset)
        labeled_slices = patients_to_slices("ACDC", self.config.labeled_num)

        def sampler_factory():
            return TwoStreamBatchSampler(
                list(range(0, labeled_slices)), list(range(labeled_slices, total_slices)),
                self.config.batch_size, self.config.batch_size - self.config.labeled_batch_size,
                seed=self.config.seed + self.current_epoch)

        valid_dataset = self._make_dataset("valid")
        valid_loader = BatchLoader(valid_dataset, batch_size=1, shuffle=False, drop_last=False)
        return train_dataset, valid_dataset, sampler_factory, valid_loader

    def _train_loader(self):
        return BatchLoader(self.train_dataset, batch_size=self.config.batch_size,
                           sampler=self._sampler_factory(), device=self.device)

    # ------------------------------------------------------------------
    # programs
    # ------------------------------------------------------------------
    def _setup_loss(self):
        if self.config.loss_name != "dice+ce":
            raise ValueError(f"Loss function {self.config.loss_name} not found")
        # CPC-SAM convention: (1-w)·CE + w·Dice through per-call weights
        self.supervised_loss = DiceAndCELoss(dice_weight=self.config.dice_weight,
                                             ce_weight=1.0 - self.config.dice_weight,
                                             smooth=1e-5, do_bg=True)
        c = self.config
        self.loss2_rampup = sigmoid_ramp_up(c.loss2_weight, c.loss2_weight_rampup_iter,
                                            c.loss2_weight_rampup_interval)
        self.loss3_rampup = sigmoid_ramp_up(c.loss3_weight, c.loss3_weight_rampup_iter,
                                            c.loss3_weight_rampup_interval)

    def _setup_optimizer(self):
        self.lr_schedule = poly_warmup_schedule(self.config.start_lr,
                                                max_steps=self.config.max_iter,
                                                warmup_steps=self.config.lr_warmup_iter)
        self.trainable = freeze_wrt_mask(self.model, lora_trainable_mask(self.model))
        self.optimizer = make_optimizer(self.config.optimizer_name, self.trainable,
                                        self.lr_schedule, grad_clip=None,
                                        **self.config.optimizer_kwargs)

    def _supervised(self, logits, labels, dice_w):
        return self.supervised_loss(logits, labels, dice_weight=dice_w, ce_weight=1.0 - dice_w)[0]

    def _apply(self, images, prompt_idx, image_embeddings=None, prompts=None, unprompted=None):
        return self.model(images, True, self.config.image_size, prompt_idx,
                          self.config.promptmode if prompt_idx >= 0 else None, image_embeddings,
                          train=True, prompts=prompts, generator=self.generator,
                          unprompted=unprompted)

    def batched_prompts(self, raws):
        """One prompt generation for every decoder: ``raws`` ``(n, B, H, W,
        C)`` detached softmaxes → per-decoder prompt tuples, decoder ``p``'s
        from the mean softmax of the others."""
        n = raws.shape[0]
        total_soft = raws.sum(0)
        assembles = torch.stack([(total_soft - raws[p]) / (n - 1) for p in range(n)])
        flat = assembles.reshape((-1,) + assembles.shape[2:])
        emb = self.model.img_size // 16
        prompts_flat = prompt_generate_random_fast(
            flat, self.config.image_size, (emb * 4, emb * 4), self.config.num_points_prompt,
            self.config.bbox_change_rate, israndom=True,
            compute_at_native=self.config.prompt_compute_size <= 0,
            max_compute_size=self.config.prompt_compute_size or 128, generator=self.generator)

        def pick(tree, p):
            if isinstance(tree, tuple):
                return tuple(pick(t, p) for t in tree)
            return tree.reshape((n, -1) + tree.shape[1:])[p]

        return [pick(prompts_flat, p) for p in range(n)]

    def _contrastive_terms(self, memory, feats, class_labels):
        """Project, predict, select and the prototype loss of one feature
        group ``(N, D)`` with its labels or predictions ``(N,)``."""
        from torch.utils.checkpoint import checkpoint

        cfg, model = self.config, self.model
        retain = (torch.rand(feats.shape[0], generator=self.generator, device=feats.device)
                  < 1.0 - cfg.contrastive_dropout_rate)
        # the heads run on every pixel of every group (millions of rows), so their
        # activations are recomputed in the backward instead of kept: the projection
        # and prediction heads as one unit, each class selector on its own
        pred_f = checkpoint(
            lambda x: model.predict_features(model.project_features(x, retain), retain), feats,
            use_reentrant=False)
        pred_d = pred_f.detach()
        sel = torch.stack([
            checkpoint(lambda x, c=c: model.select_features(c, x, retain, False)[:, 0], pred_d,
                       use_reentrant=False)
            for c in range(cfg.num_classes + 1)])
        sel_mem = torch.stack([model.select_features(c, memory.bank[c], memory.valid[c], True)[:, 0]
                               for c in range(cfg.num_classes + 1)])
        return prototype_contrastive_loss(pred_f, class_labels, retain, memory, sel, sel_mem,
                                          cfg.num_classes)

    def _contrastive_loss(self, memory, groups, labeled_labels):
        """The memory refreshed from the correct labeled predictions (no
        gradient) and ``contrastive_weight`` · (labeled + unlabeled term).
        ``groups``: per decoder pass ``(features, predictions)`` ``(B, H, W,
        D)``, ``(B, H, W)``, the labeled rows first."""
        cfg, model = self.config, self.model
        lbs = cfg.labeled_batch_size
        dim = groups[0][0].shape[-1]
        fl = torch.cat([f[:lbs].reshape(-1, dim) for f, _ in groups])
        pl = torch.cat([p[:lbs].reshape(-1) for _, p in groups])
        fu = torch.cat([f[lbs:].reshape(-1, dim) for f, _ in groups])
        pu = torch.cat([p[lbs:].reshape(-1) for _, p in groups])
        ll = labeled_labels.reshape(-1).repeat(len(groups))
        with torch.no_grad():
            correct = (pl == ll) & (pl > 0)
            proj_corr = model.project_features(fl.detach(), correct)
            scores = torch.sigmoid(torch.stack([
                model.select_features(c, proj_corr, correct, False)[:, 0]
                for c in range(cfg.num_classes + 1)]))
            new_memory = update_feature_memory(memory, proj_corr,
                                               torch.where(correct, ll, -1), scores)
        c1 = self._contrastive_terms(new_memory, fl, ll)
        c2 = self._contrastive_terms(new_memory, fu, pu)
        return cfg.contrastive_weight * (c1 + c2), new_memory

    def losses_and_memory(self, images, labels, step: int, phase2: bool, prompts=None,
                          memory=None):
        """(total, loss1, loss2, loss3, new_memory) of one step, differentiable.
        ``prompts`` (one prompt tuple per decoder) replaces the phase-2
        generation; ``memory`` defaults to the trainer's (None without the
        contrastive loss) and comes back refreshed."""
        cfg = self.config
        model = self.model
        lbs = cfg.labeled_batch_size
        n = model.num_decoders
        memory = self.memory if memory is None else memory
        # an auxiliary loss reads the unlabeled half too: nothing is sliced then
        slice_p1 = cfg.phase1_labeled_only and not (cfg.use_contrastive_loss or cfg.use_adv_loss)
        if phase2 or not slice_p1:
            image_embeddings = model.get_image_embeddings(images)
        else:
            image_embeddings = model.get_image_embeddings(images[:lbs])
        if slice_p1:
            outputs = self._apply(images[:lbs], -1, image_embeddings[:lbs])
        else:
            outputs = self._apply(images, -1, image_embeddings)
        labeled_labels = labels[:lbs]
        loss1 = sum(self._supervised(outputs["low_res_logits"][i][:lbs], labeled_labels,
                                     cfg.dice_weight) for i in range(n))
        groups = []  # (dense features, predicted classes) of every decoder pass
        if cfg.use_contrastive_loss:
            size = (cfg.image_size, cfg.image_size)
            for i in range(n):
                with torch.no_grad():  # the masks at the image size, as the JAX package reads them
                    masks = postprocess_masks(outputs["low_res_logits"][i], model.img_size, size, size)
                    pred = masks.to(torch.float32).softmax(-1).argmax(-1)
                groups.append((outputs["dense_features"][i], pred))

        loss2 = torch.zeros((), device=images.device)
        if phase2:
            shared = None
            if cfg.dropout_rate == 0:  # the unprompted stack, once for the step
                shared = model.unprompted_decoders(image_embeddings)
            if prompts is None:
                raws = (model.raw_decoder_softmaxes(image_embeddings, unprompted=shared[0])
                        if shared is not None else model.raw_decoder_softmaxes(image_embeddings))
                prompts = self.batched_prompts(raws)
            sup2 = sup2_r = cons2 = cons2_r = 0.0
            for p in range(n):
                out2 = self._apply(images, p, image_embeddings, prompts=prompts[p],
                                   unprompted=shared)
                lrl_p = out2["low_res_logits"][p]
                lrl_pr = out2["low_res_logits_r"][p]
                if cfg.use_contrastive_loss:
                    with torch.no_grad():
                        pred = lrl_p.to(torch.float32).softmax(-1).argmax(-1)
                    groups.append((out2["dense_features"][p], pred))
                sup2 = sup2 + self._supervised(lrl_p[:lbs], labeled_labels, cfg.dice_weight)
                sup2_r = sup2_r + self._supervised(lrl_pr[:lbs], labeled_labels, cfg.dice_weight)
                with torch.no_grad():
                    ens = (lrl_p.to(torch.float32).softmax(-1)
                           + lrl_pr.to(torch.float32).softmax(-1)) / 2.0
                    pseudo = ens[lbs:].argmax(-1)
                for other in range(n):
                    if other != p:
                        cons2 = cons2 + self._supervised(out2["low_res_logits"][other][lbs:],
                                                         pseudo, 0.5)
                cons2_r = cons2_r + self._supervised(lrl_pr[lbs:], pseudo, 0.5)
            loss2 = (sup2 + sup2_r + cfg.consistency_weight_1 * cons2
                     + cfg.consistency_weight_2 * cons2_r)

        loss3 = torch.zeros((), device=images.device)
        if cfg.use_contrastive_loss:
            if memory is None:
                memory = init_feature_memory(cfg.num_classes, 2 * groups[0][0].shape[-1],
                                             device=images.device)
            loss3, memory = self._contrastive_loss(memory, groups, labeled_labels)
        if cfg.use_adv_loss:
            adv = vat_loss(lambda emb: self._apply(images, -1, emb)["low_res_logits"],
                           image_embeddings,
                           clean_logits_list=[m.detach() for m in outputs["low_res_logits"]],
                           generator=self.generator, **cfg.adv_loss_kwargs)
            loss3 = loss3 + cfg.adv_weight * adv
        total = loss1 + self.loss2_rampup(step) * loss2 + self.loss3_rampup(step) * loss3
        return total, loss1, loss2, loss3, memory

    def compute_losses(self, images, labels, step: int, phase2: bool, prompts=None):
        """(total, loss1, loss2, loss3) of :meth:`losses_and_memory`; the
        trainer's memory is left as it is."""
        return self.losses_and_memory(images, labels, step, phase2, prompts)[:4]

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def on_train_start(self):
        (self.train_dataset, self.valid_dataset, self._sampler_factory,
         self.valid_dataloader) = self.get_data()
        self._setup_loss()
        self._setup_optimizer()
        if self.config.maximum_save_metric is None:
            self.config.maximum_save_metric = self.config.save_metric_name == "dice"
        default = -np.inf if self.config.maximum_save_metric else np.inf
        self._best_valid_metric = default
        self._cur_valid_metric = default
        if self.config.use_contrastive_loss:
            dim_in = 256 // 16  # the decoders' dense-feature channels
            self.memory = init_feature_memory(self.config.num_classes, 2 * dim_in,
                                              device=self.device)
        if self.resume is not None:
            self.load_state_dict(self.resume)
        self.config.save(self.work_path / "config.json")
        name = (torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu")
        self.logger.info(f"device: {self.device} ({name}); trainable parameters: "
                         f"{sum(p.numel() for p in self.trainable)}")

    def train_step(self, sampled_batch):
        start = time.time()
        self.logger.info(f"Iteration {self.current_iter}:")
        images = torch.as_tensor(sampled_batch["image"], device=self.device).to(torch.float32)
        labels = torch.as_tensor(sampled_batch["label"], device=self.device).long()
        phase2 = self.current_iter >= self.config.warmup_iter
        total, l1, l2, l3, new_memory = self.losses_and_memory(images, labels, self.current_iter,
                                                               phase2)
        grads = torch.autograd.grad(total, self.trainable, allow_unused=True)
        self.memory = new_memory
        # a parameter this phase does not reach gets a zero gradient, as in optax
        self.optimizer.step([torch.zeros_like(p) if g is None else g
                             for p, g in zip(self.trainable, grads)])
        lr = self.lr_schedule(self.current_iter)
        self._pending_train_logs.append(
            (self.current_iter, lr, torch.stack([total, l1, l2, l3]).detach()))
        log_every = max(1, int(getattr(self.config, "log_every_iters", 1)))
        if log_every <= 1:
            # one-iteration lag: the previous step's losses are fetched while
            # this step's kernels are queued
            while len(self._pending_train_logs) > 1:
                self._log_train(*self._pending_train_logs.pop(0))
        elif (self.current_iter + 1) % log_every == 0:
            self._flush_train_logs()
        self.logger.info(f"Iteration time elapsed: {time.time() - start:.3f} seconds")
        self.logger.info("")
        self.current_iter += 1

    def _log_train(self, step, lr, losses):
        losses = [float(v) for v in losses.cpu()]
        self.logger.info(f"Iteration {step} lr: {lr} Loss: {losses}")
        self.epoch_train_outputs.append({"loss": losses})

    def _flush_train_logs(self):
        pending, self._pending_train_logs = self._pending_train_logs, []
        for item in pending:
            self._log_train(*item)

    def _eval_apply(self, images):
        return self.model(images, True, self.config.image_size, -1, None)

    def valid_step(self, sampled_batch):
        metric, loss = test_single_volume(
            sampled_batch["image"], sampled_batch["label"], self._eval_apply,
            classes=self.config.num_classes + 1,
            patch_size=(self.config.image_size, self.config.image_size),
            loss_fn=self.supervised_loss, defer=True, device=self.device)
        self.epoch_valid_outputs.append({"metric": metric, "loss": loss})

    def on_valid_epoch_end(self):
        # one fetch for the whole epoch
        metrics = torch.stack([o["metric"] for o in self.epoch_valid_outputs]).cpu().numpy()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            per_cls = np.nanmean(metrics, axis=0)
            avg_dsc = float(np.nanmean(per_cls[:, 0]))
            avg_hd95 = float(np.nanmean(per_cls[:, 1]))
        self.logger.info("Valid results (DSC, HD95):")
        self.logger.info(f"  per-class: {per_cls.tolist()}")
        self.logger.info(f"  mean dsc: {avg_dsc} hd95: {avg_hd95}")
        if self.config.save_metric_name == "dice":
            self._cur_valid_metric = avg_dsc
        elif self.config.save_metric_name == "hd":
            self._cur_valid_metric = avg_hd95
        improved = (self._cur_valid_metric > self._best_valid_metric
                    if self.config.maximum_save_metric
                    else self._cur_valid_metric < self._best_valid_metric)
        if improved:
            self._best_valid_metric = self._cur_valid_metric
            self.save_state_dict(self.work_path / "best_model")
            self.current_patience = 0
        else:
            self.current_patience += 1
        self.logger.info(f"current_patience: {self.current_patience}")

    def valid(self):
        if self.current_iter % self.config.valid_freq_iter == 0:
            self._flush_train_logs()
            self.epoch_valid_outputs = []
            for sampled_batch in self.valid_dataloader:
                self.valid_step(sampled_batch)
            self.on_valid_epoch_end()

    def is_finished(self):
        if self.current_iter < self.config.min_iter:
            return False
        if (self.config.early_stop_max_patience
                and self.current_patience >= self.config.early_stop_max_patience):
            self.logger.info("Exceeded maximum patience. Training will be early stopped")
            return True
        return self.current_iter >= self.config.max_iter

    def train(self):
        self.on_train_start()
        while not self.is_finished() and self.current_epoch < self.config.num_epochs:
            self.logger.info(f"Epoch {self.current_epoch}:")
            self.epoch_train_outputs = []
            for sampled_batch in self._train_loader():
                if self.is_finished():
                    break
                self.train_step(sampled_batch)
                self.valid()
            self._flush_train_logs()
            if (self.config.save_freq_epoch
                    and (self.current_epoch + 1) % self.config.save_freq_epoch == 0):
                self.save_state_dict(self.work_path / f"epoch_{self.current_epoch}", True)
            self.current_epoch += 1
        self.save_state_dict(self.work_path / "final_model", True)
        self.perform_real_test()

    def run_training(self):
        self.train()

    def perform_real_test(self):
        if not hasattr(self, "supervised_loss"):
            self._setup_loss()
        loader = BatchLoader(self._make_dataset("test"), batch_size=1, shuffle=False,
                             drop_last=False)
        save_path = self.work_path / "predictions"
        metric_rows = []
        for batch in loader:
            spacing = batch.get("spacing")
            raw_spacing = None
            if spacing is not None and spacing[0] is not None:
                sp = np.asarray(spacing[0], np.float32)
                raw_spacing = np.roll(sp, 1) if sp.size == 3 else None
            metric_rows.append(test_single_volume_mean(
                Path(self.config.data_path), batch["image"], batch["label"], self._eval_apply,
                classes=self.config.num_classes + 1,
                patch_size=(self.config.image_size, self.config.image_size),
                test_save_path=save_path, case=batch["case_name"][0], raw_spacing=raw_spacing,
                device=self.device))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            per_cls = np.nanmean(np.asarray(metric_rows), axis=0)  # (C-1, 4)
            overall = np.nanmean(per_cls, axis=0)
        self.logger.info("Real test results (DSC, HD, ASD, JC):")
        self.logger.info(f"  per-class: {per_cls.tolist()}")
        self.logger.info(f"  average: {overall.tolist()}")
        with open(self.work_path / "test_mean.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["class", "DSC", "HD", "ASD", "JC"])
            for c, row in enumerate(per_cls, start=1):
                writer.writerow([c] + [float(v) for v in row])
        return {"dsc": float(overall[0]), "hd": float(overall[1])}
