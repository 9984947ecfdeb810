"""Trainers: the shared machinery, denoising score training, and the S2EF
(energy and forces) trainer.

Port of :mod:`adsorbdiff_tpu.train.trainer` for one device (a CUDA card, or
the host when the config says ``cpu: true``):

- the model is an ``nn.Module`` whose ``nn.Parameter``s train; ScaleFactors
  are buffers and stay out of the optimiser, as JAX keeps its
  ``scale_factors`` collection out of ``params``;
- the update follows the JAX step's optax chain, written out on the device:
  ``clip_by_global_norm`` (scale by max/norm, no epsilon), then ``adamw``
  (Adam moments, bias correction, weight decay on every parameter, learning
  rate ``schedule(count)`` with the count taken before the update), then the
  EMA.  A non-finite loss leaves params, both moments, the count and the EMA
  exactly unchanged through device-side masks, so no step reads the device.
  Params, moments and EMA each live in one flat buffer (every parameter a
  view of it), so the update is ~30 launches whatever the model's size;
- ``optim.grad_accumulation_steps`` k > 1 is ``optax.MultiSteps`` (gradient
  mean): the running mean of k micro-steps' gradients is clipped and fed to
  AdamW at the k-th, so params, moments and the schedule's count move once
  per k, while the EMA decays toward the (unchanged) params at every
  micro-step, as in JAX;
- ``optim.scheduler: ReduceLROnPlateau`` is the JAX chain's
  ``optax.contrib.reduce_on_plateau(factor [0.8], patience [3])`` after
  AdamW at the constant ``lr_initial``: the update is scaled by a factor that
  drops by ``factor`` after ``patience`` steps whose training loss (NaN ->
  1e9) did not improve on the best by a relative 1e-4.  Its state, like the
  accumulator's, is device tensors, kept in checkpoints;
- ``optim.atom_budget`` gives atom-balanced batches (batch size ``min(
  batch_size, atom_budget // bucket edge)``) to the training, validation and
  relax batchers;
- losses drain to the host in one read per logging window;
- a model with drop regularisers (EquiformerV2) is built in train mode and
  draws its masks from a per-step dropout generator seeded from
  (seed, step), separate from the noise generator, so the noise does not
  change when drops are on (JAX's ``fold_in(key, 1)``); the EMA copy, which
  validation and score prediction run, is in eval mode and draws nothing;
- ``DenoisingTrainer.run_relaxations`` samples the ``task.relax_dataset``
  with the EMA model through :class:`DiffusionEngine`, batch i from a
  ``torch.Generator`` seeded from (seed + 2, i), where JAX folds i into
  ``PRNGKey(seed + 2)``: the samples differ between the packages by design;
- ``S2EFTrainer`` (the ``forces`` trainer of ``gemnet_relax.yml``) trains on
  energy and forces, and predicts, validates and relaxes with the EMA
  model: ``energy_forces_fn`` is the relaxer that ``run_pipeline`` and
  ``run_relaxations`` drive;
- ``model.scale_file`` loads reference scale factors into the model's
  ScaleFactor buffers at ``init_state`` (:func:`load_scales_compat`).

``amp`` (``--amp``) sets ``model.compute_dtype: bfloat16`` where the model
config names none, for the trained model, its EMA copy (the sampling and
evaluation model) and so every path a trainer drives: the JAX trainer's
rule.  Parameters, optimiser state, losses and outputs stay f32.

Not ported (raise ``NotImplementedError``): several devices (A.9).
"""
from __future__ import annotations

import copy
import inspect
import itertools
import logging
import math
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from adsorbdiff_tpu_torch.common.logging_utils import setup_logging
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.data.buckets import BucketedBatcher
from adsorbdiff_tpu_torch.data.prefetch import Prefetcher, to_device
from adsorbdiff_tpu_torch.data.schema import AtomsBatch
from adsorbdiff_tpu_torch.data.store import ShardDataset
from adsorbdiff_tpu_torch.device import DeviceLike, resolve_device
from adsorbdiff_tpu_torch.diffusion.schedules import ScheduleDraws, ads_com_gaussian_schedule, tr_so3_schedule
from adsorbdiff_tpu_torch.models import equiformer_v2, gemnet_oc, painn  # noqa: F401  (registers the models)
from adsorbdiff_tpu_torch.ops.pbc import auto_cell_reps
from adsorbdiff_tpu_torch.relaxation.continuous import ContinuousRelaxationEngine, resolve_continuous
from adsorbdiff_tpu_torch.relaxation.lbfgs import candidate_fn_for
from adsorbdiff_tpu_torch.relaxation.ml_relaxation import DiffusionEngine, RelaxationEngine, batch_generator
from adsorbdiff_tpu_torch.train import checkpoint as ckpt
from adsorbdiff_tpu_torch.train.evaluator import Evaluator
from adsorbdiff_tpu_torch.train.loss import atomwise_l2, denoising_loss, l2mae, mae, mse
from adsorbdiff_tpu_torch.train.lr import build_lr_schedule
from adsorbdiff_tpu_torch.train.normalizer import Normalizer
from adsorbdiff_tpu_torch.train.scaling import ensure_fitted, load_scales_compat

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw defaults
PLATEAU_RTOL = 1e-4  # optax.contrib.reduce_on_plateau's default (atol 0, cooldown 0; min_scale 0 never binds)
# reference config keys the models take elsewhere or not at all
_CONFIG_ONLY_KEYS = ("name", "scale_file", "regress_forces", "direct_forces", "use_pbc", "otf_graph")


def _model_from_config(model_cfg: dict, *, mode: Optional[str], device: torch.device,
                       generator: torch.Generator, training: bool = False, amp: bool = False) -> torch.nn.Module:
    """The configured model; ``training`` builds it in train mode where the
    class has drop regularisers (a ``training`` argument), and the drop-rate
    keys are dropped for a class without them; ``amp`` computes in bf16
    where the config sets no ``compute_dtype`` (the JAX trainer's rules)."""
    cfg = {k: v for k, v in model_cfg.items() if k not in _CONFIG_ONLY_KEYS}
    if amp and "compute_dtype" not in cfg:
        cfg["compute_dtype"] = "bfloat16"
    cls = registry.get_model_class(model_cfg.get("name", "painn"))
    accepted = inspect.signature(cls).parameters
    for key in ("alpha_drop", "drop_path_rate", "proj_drop", "training"):
        if key not in accepted:
            cfg.pop(key, None)
    if "training" in accepted:
        cfg["training"] = training
    if mode is not None:
        cfg["mode"] = mode
    if "cell_reps" in cfg:
        cfg["cell_reps"] = tuple(cfg["cell_reps"])
    return cls(**cfg, device=device, generator=generator)


def _flatten_parameters(module: torch.nn.Module) -> torch.Tensor:
    """Move every parameter of ``module`` into one flat buffer, each
    parameter becoming a view of it, and return the buffer: the optimiser
    then updates all of them in a few whole-buffer launches."""
    params = list(module.parameters())
    flat = torch.cat([p.detach().reshape(-1) for p in params])
    offset = 0
    for p in params:
        p.data = flat[offset:offset + p.numel()].view_as(p)
        offset += p.numel()
    return flat


def _views(flat: torch.Tensor, like: List[torch.Tensor]) -> List[torch.Tensor]:
    out, offset = [], 0
    for p in like:
        out.append(flat[offset:offset + p.numel()].view_as(p))
        offset += p.numel()
    return out


def _step_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The noise generator of one step: seeded from (seed, step), so a resumed
    run draws what an uninterrupted one would."""
    return torch.Generator(device=device).manual_seed(int(seed) * 1_000_003 + int(step))


def _dropout_generator(device: torch.device, seed: int, step: int) -> torch.Generator:
    """The drop-mask generator of one step: seeded from (seed, step) and a
    stream tag of its own, so it never shares a seed with the noise."""
    state = np.random.SeedSequence([int(seed), int(step), 1]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


class BaseTrainer:
    """Datasets, model, optimiser state, checkpoints and the training loop."""

    name = "base"

    def __init__(self, config: dict, device: DeviceLike = None) -> None:
        setup_logging()
        self.config = config
        self.optim_cfg = config["optim"]
        self.model_cfg = dict(config["model"])
        self.task_cfg = config.get("task", {}) or {}
        if int(config.get("num_devices") or 1) > 1:
            raise NotImplementedError("several devices is not ported yet")
        self.device = resolve_device("cpu" if config.get("cpu") else device)
        self.seed = int(config.get("seed", 0) or 0)
        self.run_dir = config.get("run_dir", "./")
        self.identifier = config.get("identifier", "run") or "run"
        self.ckpt_dir = os.path.join(self.run_dir, "checkpoints", self.identifier)
        self.results_dir = os.path.join(self.run_dir, "results", self.identifier)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        os.makedirs(self.results_dir, exist_ok=True)

        self._datasets(config)  # before the model: cell_reps: auto reads the data
        self._resolve_auto_cell_reps()
        # the model trains in train mode (drops on where it has them); the EMA
        # copy made from it in init_state runs in eval mode
        self.model = _model_from_config(self.model_cfg, mode=self._model_mode(), device=self.device,
                                        generator=torch.Generator().manual_seed(self.seed), training=True,
                                        amp=bool(config.get("amp")))
        self._normalizers(config)
        self._optimizer()
        self.initialized = False
        # True once a checkpoint supplies scale factors (the JAX trainer's
        # explicit fitted state); False after a fresh init
        self.scale_factors_fitted: Optional[bool] = None
        self.evaluator = Evaluator(task=self.name if self.name in Evaluator.task_metrics else "ocp")
        self.logger = self._logger(config)
        self.step = 0
        self.epoch = 0.0
        self.best_val_metric = float(config.get("best_val_metric", 1e9))
        self._copy_stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def _model_mode(self) -> Optional[str]:
        return None

    def _resolve_auto_cell_reps(self, num_samples: int = 64) -> None:
        """``model.cell_reps: auto``: image counts from a sample of the data
        (:func:`adsorbdiff_tpu_torch.ops.pbc.auto_cell_reps`)."""
        if self.model_cfg.get("cell_reps") != "auto":
            return
        ds = self.train_dataset or self.relax_dataset or self.val_dataset
        cutoff = max([float(v) for k, v in self.model_cfg.items() if k.startswith("cutoff")] or [12.0])
        if ds is None or len(ds) == 0:
            self.model_cfg["cell_reps"] = (2, 2, 1)
            logging.warning("cell_reps: auto with no dataset; using (2, 2, 1)")
            return
        idx = np.linspace(0, len(ds) - 1, min(len(ds), num_samples)).astype(int)
        samples = [ds[int(i)] for i in idx]
        reps = auto_cell_reps([s.pos for s in samples], [s.cell for s in samples], cutoff)
        self.model_cfg["cell_reps"] = tuple(int(r) for r in reps)
        logging.info(f"cell_reps: auto -> {self.model_cfg['cell_reps']} (cutoff {cutoff})")

    # ------------------------------------------------------------------ setup
    def _logger(self, config):
        if config.get("is_debug") or not config.get("logger"):
            return None
        logger_cfg = config["logger"]
        name = logger_cfg if isinstance(logger_cfg, str) else logger_cfg.get("name", "tensorboard")
        return registry.get_logger_class(name)({
            "cmd": {"logs_dir": os.path.join(self.run_dir, "logs", self.identifier)},
            "logger": logger_cfg if isinstance(logger_cfg, dict) else {},
        })

    def _datasets(self, config) -> None:
        ds_cfg = config.get("dataset")
        self.train_dataset = self.val_dataset = self.relax_dataset = None
        self.train_batcher = self.val_batcher = self.relax_batcher = None
        bs = int(self.optim_cfg.get("batch_size", 4))
        eval_bs = int(self.optim_cfg.get("eval_batch_size", bs))
        with_forces = self.name == "s2ef"  # the training and validation targets; relax batches carry none
        # atom-balanced per-bucket batch sizes (batch_size becomes the cap); one device: no multiple
        budget = self.optim_cfg.get("atom_budget")
        entries = (ds_cfg if isinstance(ds_cfg, list) else [ds_cfg]) if ds_cfg else []
        if entries and entries[0].get("src"):
            self.train_dataset = ShardDataset(entries[0])
            self.train_batcher = BucketedBatcher(self.train_dataset, bs, seed=self.seed, shuffle=True,
                                                 with_forces=with_forces, atom_budget=budget)
        if len(entries) > 1 and entries[1].get("src"):
            self.val_dataset = ShardDataset(entries[1])
            self.val_batcher = BucketedBatcher(self.val_dataset, eval_bs, seed=self.seed, shuffle=False,
                                               with_forces=with_forces, atom_budget=budget)
        relax_cfg = self.task_cfg.get("relax_dataset")
        if relax_cfg and relax_cfg.get("src"):
            self.relax_dataset = ShardDataset(relax_cfg)
            self.relax_batcher = BucketedBatcher(self.relax_dataset, eval_bs, seed=self.seed, shuffle=False,
                                                 atom_budget=budget)

    def _normalizers(self, config) -> None:
        self.normalizers: Dict[str, Normalizer] = {}
        ds_cfg = config.get("dataset")
        entry = (ds_cfg[0] if isinstance(ds_cfg, list) else ds_cfg) or {}
        if entry.get("normalize_labels"):
            self.normalizers["energy"] = Normalizer(
                mean=float(entry.get("target_mean", 0.0)), std=float(entry.get("target_std", 1.0)))
            if "grad_target_mean" in entry or "grad_target_std" in entry:
                self.normalizers["forces"] = Normalizer(
                    mean=float(entry.get("grad_target_mean", 0.0)), std=float(entry.get("grad_target_std", 1.0)))

    def _optimizer(self) -> None:
        n_iter = len(self.train_batcher) if self.train_batcher is not None else 1
        self.plateau = str(self.optim_cfg.get("scheduler", "")) == "ReduceLROnPlateau"
        if self.plateau:
            lr = float(self.optim_cfg["lr_initial"])
            self.lr_schedule = lambda step: lr
            self.plateau_factor = float(self.optim_cfg.get("factor", 0.8))
            self.plateau_patience = int(self.optim_cfg.get("patience", 3))
            if not 0.0 < self.plateau_factor < 1.0:  # as optax refuses it
                raise ValueError(f"ReduceLROnPlateau factor must be in (0, 1), got {self.plateau_factor}")
        else:
            self.lr_schedule = build_lr_schedule({
                **self.optim_cfg,
                "scheduler_params": {
                    **(self.optim_cfg.get("scheduler_params", {}) or {}),
                    "epochs": self.optim_cfg.get("max_epochs", 1),
                },
            }, n_iter)
        # effective batch = grad_accumulation_steps x batch_size
        self.accumulation = int(self.optim_cfg.get("grad_accumulation_steps", 1) or 1)
        self.weight_decay = float((self.optim_cfg.get("optimizer_params", {}) or {}).get("weight_decay", 0.0))
        clip = self.optim_cfg.get("clip_grad_norm")
        self.clip_grad_norm = float(clip) if clip else None
        self.ema_decay = self.optim_cfg.get("ema_decay")

    # ------------------------------------------------------------ state
    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def init_state(self) -> None:
        """Fresh optimiser state (zero moments, count 0; with accumulation a
        zero gradient mean and mini-step 0; with the plateau schedule best
        +inf, plateau count 0, scale 1) and EMA = params.  The EMA lives in an
        eval-mode copy of the model (:attr:`ema_module`), whose parameters the
        update writes in place.  ``model.scale_file`` loads its scale factors
        into the model's buffers first, and they count as fitted (the JAX
        trainer's ``init_state``)."""
        scale_file = self.model_cfg.get("scale_file")
        with torch.no_grad():
            if scale_file:
                factors = self.scale_factors()
                for name, value in load_scales_compat(factors, scale_file).items():
                    factors[name].copy_(value)
            self._flat = _flatten_parameters(self.model)
            self.ema_module = copy.deepcopy(self.model).requires_grad_(False).eval()
            self._ema_flat = _flatten_parameters(self.ema_module)
            self._mu_flat = torch.zeros_like(self._flat)
            self._nu_flat = torch.zeros_like(self._flat)
            self.count = torch.zeros((), dtype=torch.int32, device=self.device)
            if self.accumulation > 1:
                self._acc_flat = torch.zeros_like(self._flat)
                self.mini_step = torch.zeros((), dtype=torch.int32, device=self.device)
            if self.plateau:
                self.plateau_best = torch.full((), float("inf"), device=self.device)
                self.plateau_count = torch.zeros((), dtype=torch.int32, device=self.device)
                self.plateau_scale = torch.ones((), device=self.device)
        params = self.params
        self.mu, self.nu = _views(self._mu_flat, params), _views(self._nu_flat, params)
        self.acc = _views(self._acc_flat, params) if self.accumulation > 1 else None
        self.ema = list(self.ema_module.parameters())
        self.initialized = True
        self.scale_factors_fitted = bool(scale_file)

    def scale_factors(self) -> Dict[str, torch.Tensor]:
        """The model's ScaleFactor buffers by name."""
        return {n: b for n, b in self.model.named_buffers() if n.endswith("scale_factor")}

    def _extra_opt_state(self) -> Dict[str, torch.Tensor]:
        """The scalar state of accumulation and the plateau schedule, by
        checkpoint name."""
        out = {}
        if self.accumulation > 1:
            out["mini_step"] = self.mini_step
        if self.plateau:
            out.update(plateau_best=self.plateau_best, plateau_count=self.plateau_count,
                       plateau_scale=self.plateau_scale)
        return out

    def state_dict(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        opt_state = {"count": self.count, "mu": dict(zip(names, self.mu)), "nu": dict(zip(names, self.nu)),
                     **self._extra_opt_state()}
        if self.accumulation > 1:
            opt_state["acc"] = dict(zip(names, self.acc))
        return {
            "step": self.step,
            "params": {n: params[n].detach() for n in names},
            "ema_params": dict(zip(names, self.ema)),
            "scale_factors": self.scale_factors(),
            "opt_state": opt_state,
        }

    def load_state_dict(self, state: dict) -> None:
        if not self.initialized:
            self.init_state()
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        buffers = dict(self.model.named_buffers())
        with torch.no_grad():
            for n in names:
                params[n].copy_(state["params"][n])
            for n, v in state.get("scale_factors", {}).items():
                buffers[n].copy_(v)
            self.ema_module.load_state_dict(self.model.state_dict())  # the buffers; EMA params follow
            for i, n in enumerate(names):
                self.ema[i].copy_(state["ema_params"][n])
                self.mu[i].copy_(state["opt_state"]["mu"][n])
                self.nu[i].copy_(state["opt_state"]["nu"][n])
                if self.accumulation > 1:
                    self.acc[i].copy_(state["opt_state"]["acc"][n])
            self.count.copy_(state["opt_state"]["count"])
            for key, value in self._extra_opt_state().items():
                value.copy_(state["opt_state"][key])
        self.step = int(state["step"])
        if state.get("scale_factors"):  # a checkpoint's scale factors count as fitted, as in JAX
            self.scale_factors_fitted = True

    def save(self, name: str = "checkpoint") -> str:
        return ckpt.save_checkpoint(self.ckpt_dir, name, self.state_dict(), config=self.config)

    def load_checkpoint(self, path: str) -> None:
        state, _ = ckpt.load_checkpoint(path)
        self.load_state_dict(state)

    # ------------------------------------------------------------ the update
    def _loss_and_aux(self, batch: AtomsBatch, draws: Optional[ScheduleDraws],
                      generator: Optional[torch.Generator], dropout_generator: Optional[torch.Generator] = None,
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def train_step(self, batch: AtomsBatch, draws: Optional[ScheduleDraws] = None,
                   generator: Optional[torch.Generator] = None,
                   dropout_generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One optimiser step on ``batch`` (on the trainer's device); the
        noise comes from ``draws`` or ``generator``, a model's drop masks
        from ``dropout_generator``.  Returns device scalars ``loss`` (and
        its parts) and ``grad_norm`` (before clipping)."""
        if not self.initialized:
            self.init_state()
        loss, aux = self._loss_and_aux(batch, draws, generator, dropout_generator)
        params = self.params
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return self._finalize_train_step(loss, aux, grads)

    @torch.no_grad()
    def _finalize_train_step(self, loss: torch.Tensor, aux: Dict[str, torch.Tensor],
                             grads: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """NaN-masked clip + AdamW (+ plateau scale) + EMA, as optax's chain
        computes them (inside ``optax.MultiSteps`` with accumulation), on the
        flat buffers."""
        good = torch.isfinite(loss)
        g = torch.cat([x.reshape(-1) for x in grads])
        g = torch.where(good, g, torch.zeros((), dtype=g.dtype, device=g.device))
        grad_norm = torch.sqrt(torch.sum(g * g))  # the micro-step's, as JAX reports it
        keep = good  # where params, moments, the count and the plateau state take their new values
        if self.accumulation > 1:
            # Welford's running mean over the micro-steps; the chain runs on it and is kept at the k-th
            acc = self._acc_flat + (g - self._acc_flat) / (self.mini_step + 1)
            emit = self.mini_step == self.accumulation - 1
            keep = good & emit
            torch.where(good, torch.where(emit, torch.zeros((), device=acc.device), acc), self._acc_flat,
                        out=self._acc_flat)
            torch.where(good, (self.mini_step + 1) % self.accumulation, self.mini_step, out=self.mini_step)
            g = acc
        g_norm = torch.sqrt(torch.sum(g * g)) if self.accumulation > 1 else grad_norm
        if self.clip_grad_norm is not None:
            g = torch.where(g_norm < self.clip_grad_norm, g, (g / g_norm) * self.clip_grad_norm)

        flat = self._flat
        count_inc = self.count + 1
        step_f = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(ADAM_B1, step_f)  # a Python base: no host-to-device copy, which would wait on the card
        bc2 = 1 - torch.pow(ADAM_B2, step_f)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * self._mu_flat
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self._nu_flat
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if self.weight_decay:
            update = update + self.weight_decay * flat
        update = (-self.lr_schedule(self.count)) * update
        if self.plateau:
            update = self._plateau_scale(loss, keep) * update
        new_flat = flat + update

        torch.where(keep, new_flat, flat, out=flat)
        torch.where(keep, mu, self._mu_flat, out=self._mu_flat)
        torch.where(keep, nu, self._nu_flat, out=self._nu_flat)
        torch.where(keep, count_inc, self.count, out=self.count)
        if self.ema_decay:
            d = np.float32(self.ema_decay)  # JAX takes 1 - d in f32
            new_ema = float(d) * self._ema_flat + float(np.float32(1) - d) * flat
        else:
            new_ema = flat
        # JAX's decay-1 form on a bad step would take in 0 * a NaN parameter
        torch.where(good, new_ema, self._ema_flat, out=self._ema_flat)
        aux = {k: v.detach() for k, v in aux.items()}
        aux["grad_norm"] = grad_norm
        return aux

    def _plateau_scale(self, loss: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
        """``reduce_on_plateau``'s update with this step's loss as the value
        (accumulation size 1): the new scale, which the state takes where
        ``keep``."""
        value = torch.nan_to_num(loss.detach().to(torch.float32), nan=1e9)
        improved = value < (1 - PLATEAU_RTOL) * self.plateau_best
        count = torch.where(improved, torch.zeros_like(self.plateau_count), self.plateau_count + 1)
        hit = count == self.plateau_patience
        scale = torch.where(hit, self.plateau_scale * self.plateau_factor, self.plateau_scale)
        torch.where(keep, torch.where(improved, value, self.plateau_best), self.plateau_best, out=self.plateau_best)
        torch.where(keep, torch.where(hit, torch.zeros_like(count), count), self.plateau_count,
                    out=self.plateau_count)
        torch.where(keep, scale, self.plateau_scale, out=self.plateau_scale)
        return scale

    # ------------------------------------------------------------------ train
    def _batches(self, batcher, skip: int = 0, depth: int = 2):
        """``(i, batch on the device)`` from ``batcher``, skipping the first
        ``skip`` before any copy; collation and the copy run ``depth``
        batches ahead on a worker thread (none with ``depth`` 0)."""
        def indexed():
            for i, b in enumerate(batcher):
                if i >= skip:
                    yield i, b

        if depth <= 0:
            for i, b in indexed():
                yield i, to_device(b, self.device).get()
            return
        for i, ready in Prefetcher(indexed(), lambda t: (t[0], to_device(t[1], self.device, self._copy_stream)),
                                   depth=depth):
            yield i, ready.get()

    def train(self, disable_eval_tqdm: bool = True) -> None:
        if self.train_batcher is None:
            raise ValueError("no training dataset configured")
        optim = self.optim_cfg
        n_iter = len(self.train_batcher)
        eval_every = int(optim.get("eval_every", n_iter))
        checkpoint_every = int(optim.get("checkpoint_every", eval_every))
        max_epochs = int(optim.get("max_epochs", 1))
        print_every = int(self.config.get("print_every", 100))
        prefetch_depth = int(optim.get("prefetch_depth", 2))
        if not self.initialized:
            self.init_state()

        start_epoch = self.step // n_iter
        nan_count = 0
        metrics: Dict[str, Any] = {}
        t_last = time.time()
        pending: List[torch.Tensor] = []  # device losses since the last read

        def drain() -> bool:
            """Read the pending losses in one copy; False stops training."""
            nonlocal nan_count, metrics
            if not pending:
                return True
            vals = torch.stack(pending).cpu().tolist()
            pending.clear()
            for loss in vals:
                if not math.isfinite(loss):
                    nan_count += 1
                    if nan_count > 10:
                        logging.warning("Too many NaN losses, stopping training")
                        return False
                    continue
                nan_count = 0
                if loss > 1e6:
                    logging.warning(f"Loss too high: {loss}")
                    return False
                metrics = self.evaluator.update("loss", loss, metrics)
            return True

        for epoch in range(start_epoch, max_epochs):
            self.train_batcher.set_epoch(epoch)
            for i, batch in self._batches(self.train_batcher, skip=self.step % n_iter, depth=prefetch_depth):
                self.epoch = epoch + (i + 1) / n_iter
                self.step = epoch * n_iter + i + 1
                drops = getattr(self.model, "has_drops", False)
                aux = self.train_step(batch, generator=_step_generator(self.device, self.seed, self.step),
                                      dropout_generator=_dropout_generator(self.device, self.seed, self.step)
                                      if drops else None)
                pending.append(aux["loss"])

                if self.step % print_every == 0 or i == 0 or i == n_iter - 1:
                    if not drain():
                        return
                    dt = time.time() - t_last
                    t_last = time.time()
                    log = {k: metrics[k]["metric"] for k in metrics}
                    log.update({"lr": float(self.lr_schedule(self.step)), "epoch": self.epoch, "step": self.step})
                    logging.info(", ".join(f"{k}: {v:.2e}" for k, v in log.items()) + f" ({dt:.1f}s)")
                    if self.logger:
                        self.logger.log(log, step=self.step, split="train")

                if checkpoint_every != -1 and self.step % checkpoint_every == 0:
                    if not drain():
                        return
                    self.save("checkpoint")
                if self.step % eval_every == 0 and self.val_batcher is not None:
                    if not drain():
                        return
                    self._update_best(self.validate("val"))
            if checkpoint_every == -1:
                if not drain():
                    return
                self.save("checkpoint")
        drain()

    def _update_best(self, val_metrics: dict) -> None:
        primary = self.task_cfg.get("primary_metric") or "loss"
        if primary in val_metrics and val_metrics[primary]["metric"] < self.best_val_metric:
            self.best_val_metric = val_metrics[primary]["metric"]
            self.save("best_checkpoint")

    def validate(self, split: str = "val") -> dict:
        raise NotImplementedError

    # --------------------------------------------------- relaxation results
    def _write_relaxed_positions(self, ids, positions, chunk_idx) -> None:
        """``results_dir/relaxed_positions.npz``: ``ids``, the positions of
        each distinct id in one ``[sum natoms, 3]`` array, and ``chunk_idx``,
        the offsets where each id's atoms after the first begin (the JAX
        trainer's file; its positions are f32 here where JAX may store an
        object array)."""
        full_path = os.path.join(self.results_dir, "relaxed_positions.npz")
        ids = np.asarray(ids)
        _, idx = np.unique(ids, return_index=True)
        np.savez_compressed(
            full_path,
            ids=ids[idx],
            pos=np.concatenate([np.asarray(positions[i]) for i in idx]) if len(idx) else np.zeros((0, 3)),
            chunk_idx=np.cumsum(np.asarray(chunk_idx)[idx])[:-1] if len(idx) else np.zeros(0, np.int64),
        )
        logging.info(f"Writing results to {full_path}")

    def _relax_metrics(self, batch: AtomsBatch, final_pos, final_energy, metrics_is2rs, metrics_is2re):
        """IS2RS and IS2RE metrics on free atoms (``final_pos`` and
        ``final_energy`` on the host), accumulated into the two metric
        dicts."""
        host = batch.to("cpu")
        free = host.free_mask.numpy()
        natoms_free = free.sum(1)
        cells = host.cell.numpy()
        pred_pos = np.asarray(final_pos)[free]
        common = {"cell": cells, "pbc": (True, True, True), "natoms": natoms_free}
        target = {"energy": host.y_relaxed.numpy(), "positions": host.pos_relaxed.numpy()[free], **common}
        pred = {"energy": np.asarray(final_energy), "positions": pred_pos, **common}
        metrics_is2rs = Evaluator(task="is2rs").eval(pred, target, metrics_is2rs)
        metrics_is2re = Evaluator(task="is2re").eval({"energy": pred["energy"]}, {"energy": target["energy"]},
                                                      metrics_is2re)
        return metrics_is2rs, metrics_is2re

    def _log_relax_metrics(self, metrics_is2rs, metrics_is2re, split="val") -> None:
        for task_name, metrics in (("is2rs", metrics_is2rs), ("is2re", metrics_is2re)):
            log = {f"{task_name}_{k}": v["metric"] for k, v in metrics.items()}
            if log:
                logging.info(f"[{task_name}] " + ", ".join(f"{k}: {v:.4f}" for k, v in log.items()))
                if self.logger:
                    self.logger.log(log, step=self.step, split=split)

    def _relax_batches(self, batches: Iterable[Tuple[int, AtomsBatch]], relax: Callable, split: str,
                       skip_repeats: bool = False) -> None:
        """Relax each ``(i, batch)`` with ``relax(i, batch)``, which returns
        the final positions ``[B, N, 3]`` and energies ``[B]`` on the host, or
        None for a batch it skipped; then ``relaxed_positions.npz`` with
        ``task.write_pos`` (``skip_repeats``: a padded batch's repeats of its
        last sid once, as JAX's continuous branch writes them) and the
        IS2RS/IS2RE metrics, logged when the data has relaxed energies."""
        write_pos = self.task_cfg.get("write_pos", False)
        metrics_is2rs: Dict[str, Any] = {}
        metrics_is2re: Dict[str, Any] = {}
        ids, positions, chunk_idx = [], [], []
        has_targets = None
        for i, batch in batches:
            result = relax(i, batch)
            if result is None:
                continue
            final_pos, final_energy = result
            if write_pos:
                natoms, sids = batch.natoms.cpu().numpy(), batch.sid.cpu().numpy()
                seen = set()
                for b in range(batch.batch_size):
                    if skip_repeats and int(sids[b]) in seen:
                        continue
                    seen.add(int(sids[b]))
                    ids.append(str(int(sids[b])))
                    positions.append(final_pos[b, : natoms[b]])
                    chunk_idx.append(int(natoms[b]))
            if has_targets is None:
                has_targets = bool((batch.y_relaxed != 0).any())
            if has_targets:
                metrics_is2rs, metrics_is2re = self._relax_metrics(
                    batch, final_pos, final_energy, metrics_is2rs, metrics_is2re)
        if write_pos:
            self._write_relaxed_positions(ids, positions, chunk_idx)
        self._log_relax_metrics(metrics_is2rs, metrics_is2re, split)

    def run_relaxations(self, split: str = "val") -> None:
        raise NotImplementedError(f"run_relaxations is not ported for the {self.name} trainer")


@registry.register_trainer("denoising")
class DenoisingTrainer(BaseTrainer):
    """Score-model training, validation and score prediction."""

    name = "ocp"

    def _model_mode(self) -> Optional[str]:
        return "denoising" if "mode" not in self.model_cfg else None

    def __init__(self, config: dict, device: DeviceLike = None) -> None:
        self.so3 = bool(config["model"].get("so3_denoising", False))
        super().__init__(config, device)
        self.denoising_pos_params = self.optim_cfg.get("denoising_pos_params", {}) or {}
        self.schedule_fn = tr_so3_schedule if self.so3 else ads_com_gaussian_schedule

    def _denoising_loss(self, model, batch, draws, generator, dropout_generator=None):
        batch = batch.replace(pos=batch.pos_relaxed)  # noise the relaxed structure
        noised, targets = self.schedule_fn(batch, self.denoising_pos_params, generator, draws=draws)
        out = model(noised) if dropout_generator is None else model(noised, dropout_generator=dropout_generator)
        out1, out2 = out if self.so3 else (out, None)
        return denoising_loss(out1, out2, noised, targets)

    def _loss_and_aux(self, batch, draws, generator, dropout_generator=None):
        return self._denoising_loss(self.model, batch, draws, generator, dropout_generator)

    @torch.no_grad()
    def validate(self, split: str = "val") -> dict:
        """EMA-weighted loss under fresh noise over the validation set."""
        if split != "val" or self.val_batcher is None:
            raise ValueError(f"no {split!r} dataset configured")
        model = self.ema_module
        metrics: Dict[str, Any] = {}
        losses = []  # device scalars; one read at the end
        for i, batch in self._batches(self.val_batcher):
            loss, _ = self._denoising_loss(model, batch, None, _step_generator(self.device, self.seed + 1, i))
            losses.append(loss)
        if losses:
            for v in torch.stack(losses).cpu().tolist():
                metrics = self.evaluator.update("loss", float(v), metrics)
        log = {k: metrics[k]["metric"] for k in metrics}
        logging.info(f"[{split}] " + ", ".join(f"{k}: {v:.4f}" for k, v in log.items()))
        if self.logger:
            self.logger.log(log, step=self.step, split=split)
        return metrics

    @torch.no_grad()
    def predict_denoising(self, batch: AtomsBatch):
        """EMA score prediction for the sampler: ``(tr [B, N, 3], rot [B, N, 3]
        or None)`` on the trainer's device, the rotation head zeroed on fixed
        atoms."""
        if not self.initialized:
            self.init_state()
        return self.score_fn(batch.to(self.device))

    def score_fn(self, batch: AtomsBatch, static_graph=None):
        """The EMA model as the sampler calls it: energy conditioning zeroed,
        as the JAX trainer's sampling model (``sampling=True``) does."""
        out = self.ema_module(batch.replace(energy=torch.zeros_like(batch.energy)), static_graph)
        out1, out2 = out if self.so3 else (out, None)
        if out2 is not None:
            out2 = torch.where(batch.fixed[..., None], torch.zeros_like(out2), out2)
        return out1, out2

    def sampling_static_fn(self):
        """``batch -> static graph`` of the sampling loop (the EMA model's
        ``prepare_static``), or None with ``task.incremental_graph: false``."""
        if not self.task_cfg.get("incremental_graph", True):
            return None
        if not self.initialized:
            self.init_state()
        return getattr(self.ema_module, "prepare_static", None)

    @torch.no_grad()
    def run_relaxations(self, split: str = "val") -> None:
        """Reverse diffusion over the relax dataset with the EMA model.

        Raises unless the scale factors are fitted (a loaded checkpoint's
        count as fitted); with ``is_debug`` it warns instead.  Task keys:
        ``relax_opt.traj_dir`` (one trajectory per system),
        ``save_full_traj`` [True], ``write_pos`` [False]
        (``relaxed_positions.npz``), ``num_relaxation_batches``.  IS2RS/IS2RE
        metrics are logged when the dataset has relaxed energies."""
        if not self.initialized:
            self.init_state()
        ensure_fitted(self.scale_factors(), warn=bool(self.config.get("is_debug")), fitted=self.scale_factors_fitted)
        if self.relax_batcher is None:
            raise ValueError("no relax_dataset configured")
        engine = DiffusionEngine(self.score_fn, self.denoising_pos_params, static_fn=self.sampling_static_fn(),
                                 device=self.device)
        traj_dir = (self.task_cfg.get("relax_opt", {}) or {}).get("traj_dir")
        save_full = self.task_cfg.get("save_full_traj", True)
        num_batches = int(self.task_cfg.get("num_relaxation_batches", int(1e9)))

        def sample(i, batch):
            res = engine.run(batch, batch_generator(self.seed + 2, i, self.device), traj_dir=traj_dir,
                             save_full_traj=save_full)
            return None if res is None else (res.batch.pos.cpu().numpy(), np.zeros(batch.batch_size))

        try:
            self._relax_batches(itertools.islice(self._batches(self.relax_batcher, depth=0), num_batches), sample,
                                split)
        finally:
            engine.flush()  # join the trajectory writes before returning


@registry.register_trainer("s2ef")
@registry.register_trainer("ocp")
@registry.register_trainer("energy")
@registry.register_trainer("forces")
class S2EFTrainer(BaseTrainer):
    """Energy and forces: training (``train``, ``train_step``, the shared
    loop and update), and with the EMA model ``predict``, ``validate``,
    ``energy_forces_fn`` (the relaxer's calculator) and ``run_relaxations``.

    The loss is the JAX ``S2EFTrainer``'s (``_make_train_step``):
    ``energy_coefficient`` [1] x ``loss_energy`` (``mae`` [default] or
    ``mse``) + ``force_coefficient`` [30] x ``loss_force`` (``l2mae``
    [default], ``atomwise*`` or ``mae``), forces on free atoms with
    ``task.train_on_free_atoms`` [True], else on every real atom.  The energy
    target is normalised, and predicted energies denormalised, by the
    ``energy`` normaliser where the first dataset entry sets
    ``normalize_labels``.  The ``forces`` normaliser that
    ``grad_target_mean``/``grad_target_std`` build is never applied, as in
    JAX.  The s2ef force heads are direct: inference runs without autograd,
    and training differentiates the loss with respect to the parameters
    only.  A trainer with no checkpoint initialises itself on first use
    (random weights, scale factors not fitted unless ``model.scale_file``
    gives them).
    """

    name = "s2ef"

    def _model_mode(self) -> Optional[str]:
        return "s2ef"

    def _loss_and_aux(self, batch, draws=None, generator=None, dropout_generator=None):
        """The energy and force losses of one batch (the noise arguments are
        not used); aux ``loss``, ``loss_energy``, ``loss_forces``."""
        optim = self.optim_cfg
        e_coef = float(optim.get("energy_coefficient", 1.0))
        f_coef = float(optim.get("force_coefficient", 30.0))
        loss_force = str(optim.get("loss_force", "l2mae"))
        out = self.model(batch) if dropout_generator is None else self.model(batch, dropout_generator=dropout_generator)
        e_target = batch.energy
        e_norm = self.normalizers.get("energy")
        if e_norm is not None:
            e_target = e_norm.norm(e_target)
        e_fn = mae if str(optim.get("loss_energy", "mae")) == "mae" else mse
        loss_e = e_fn(out["energy"], e_target, torch.ones_like(out["energy"], dtype=torch.bool))
        f_mask = batch.free_mask if bool(self.task_cfg.get("train_on_free_atoms", True)) else batch.atom_mask
        if loss_force == "l2mae":
            loss_f = l2mae(out["forces"], batch.forces, f_mask)
        elif loss_force.startswith("atomwise"):
            loss_f = atomwise_l2(out["forces"], batch.forces, f_mask, batch.natoms)
        else:
            loss_f = mae(out["forces"], batch.forces, f_mask)
        loss = e_coef * loss_e + f_coef * loss_f
        return loss, {"loss": loss, "loss_energy": loss_e, "loss_forces": loss_f}

    def _ema(self) -> torch.nn.Module:
        if not self.initialized:
            self.init_state()
        return self.ema_module

    def _denorm(self, energy: torch.Tensor) -> torch.Tensor:
        norm = self.normalizers.get("energy")
        return energy if norm is None else norm.denorm(energy)

    @torch.no_grad()
    def predict(self, batch: AtomsBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(energy [B], forces [B, N, 3])`` of the EMA model on the
        trainer's device, the energy denormalised."""
        out = self._ema()(batch.to(self.device))
        return self._denorm(out["energy"]), out["forces"]

    def energy_forces_fn(self, batch: AtomsBatch, static_graph=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """The relaxer's calculator: :meth:`predict`'s energy and forces with
        fixed atoms' forces zeroed; ``static_graph`` carries Verlet
        candidate tables into the graph build."""
        with torch.no_grad():
            out = self._ema()(batch, static_graph)
        return self._denorm(out["energy"]), torch.where(batch.fixed[..., None], 0.0, out["forces"])

    def relax_candidate_fn(self, relax_opt: Optional[dict] = None) -> Optional[Callable]:
        """The Verlet candidate-table builder ``relax_opt`` asks for (None
        with ``verlet_graph: false``)."""
        return candidate_fn_for(self._ema(), relax_opt)

    @torch.no_grad()
    def validate(self, split: str = "val") -> dict:
        """S2EF metrics over the validation set (any other ``split``: the
        relax set, whose batches carry no forces), forces on free atoms
        with ``task.eval_on_free_atoms`` [True]."""
        batcher = self.val_batcher if split == "val" else self.relax_batcher
        if batcher is None:
            raise ValueError(f"no {split!r} dataset configured")
        eval_free = bool(self.task_cfg.get("eval_on_free_atoms", True))
        evaluator = Evaluator(task="s2ef")
        metrics: Dict[str, Any] = {}
        for _, batch in self._batches(batcher):
            energy, forces = self.predict(batch)
            host = batch.to("cpu")
            m = (host.free_mask if eval_free else host.atom_mask).numpy()
            pred = {"energy": energy.cpu().numpy(), "forces": forces.cpu().numpy()[m], "natoms": m.sum(1)}
            target = {"energy": host.energy.numpy(),
                      "forces": host.forces.numpy()[m] if host.forces is not None else np.zeros_like(pred["forces"]),
                      "natoms": m.sum(1)}
            metrics = evaluator.eval(pred, target, metrics)
        log = {k: metrics[k]["metric"] for k in metrics}
        logging.info(f"[{split}] " + ", ".join(f"{k}: {v:.4f}" for k, v in log.items()))
        if self.logger:
            self.logger.log(log, step=self.step, split=split)
        return metrics

    @torch.no_grad()
    def run_relaxations(self, split: str = "val") -> None:
        """L-BFGS over the relax dataset with :meth:`energy_forces_fn`.

        Raises unless the scale factors are fitted (a loaded checkpoint's
        count as fitted); with ``is_debug`` it warns instead.
        ``task.relax_opt.continuous`` picks the engine
        (:func:`resolve_continuous`): the slot-refill engine
        (``relax_opt.slots`` [eval batch size], ``chunk_steps``) or batches
        of the relax batcher.  Task keys: ``relaxation_steps`` [300],
        ``relaxation_fmax`` [0.01], ``relax_opt.traj_dir``,
        ``save_full_traj`` [True], ``write_pos`` [False],
        ``num_relaxation_batches`` (the batch engine only).  IS2RS/IS2RE
        metrics are logged when the dataset has relaxed energies."""
        self._ema()
        ensure_fitted(self.scale_factors(), warn=bool(self.config.get("is_debug")), fitted=self.scale_factors_fitted)
        if self.relax_batcher is None:
            raise ValueError("no relax_dataset configured")
        relax_opt = dict(self.task_cfg.get("relax_opt", {}) or {})
        kw = dict(steps=int(self.task_cfg.get("relaxation_steps", 300)),
                  fmax=float(self.task_cfg.get("relaxation_fmax", 0.01)),
                  candidate_fn=self.relax_candidate_fn(relax_opt), device=self.device)
        traj_dir = relax_opt.get("traj_dir")
        save_full = self.task_cfg.get("save_full_traj", True)
        num_batches = self.task_cfg.get("num_relaxation_batches")
        if resolve_continuous(relax_opt, kw["fmax"], num_relaxation_batches=num_batches):
            self._run_relaxations_continuous(relax_opt, kw, traj_dir, save_full, split)
            return
        engine = RelaxationEngine(self.energy_forces_fn, relax_opt, **kw)

        def relax(i, batch):
            res = engine.run(batch, traj_dir=traj_dir, save_full_traj=save_full)
            return None if res is None else (res.batch.pos.cpu().numpy(), res.energy.cpu().numpy())

        try:
            capped = itertools.islice(enumerate(self.relax_batcher), int(1e9) if num_batches is None else num_batches)
            self._relax_batches(capped, relax, split)
        finally:
            engine.flush()  # join the trajectory writes before returning

    def _run_relaxations_continuous(self, relax_opt: dict, kw: dict, traj_dir: Optional[str], save_full: bool,
                                    split: str) -> None:
        """The slot-refill engine over the whole relax dataset (converged
        systems retire at chunk boundaries, pending ones take their slots;
        ``num_relaxation_batches`` does not apply); then the metrics and
        ``write_pos`` over the relax batcher's batches, each row's relaxed
        positions and energy taken from the results."""
        engine = ContinuousRelaxationEngine(self.energy_forces_fn, relax_opt,
                                            slots=int(relax_opt.get("slots", self.relax_batcher.batch_size)), **kw)
        results = engine.run_dataset(self.relax_dataset, traj_dir=traj_dir, save_full_traj=save_full)

        def relaxed(i, batch):
            sids, natoms = batch.sid.numpy(), batch.natoms.numpy()
            if not all(int(s) in results for s in sids):
                return None  # skipped: its trajectories exist
            final_pos = batch.pos.numpy().copy()
            final_energy = np.zeros(batch.batch_size, np.float32)
            for b in range(batch.batch_size):
                r = results[int(sids[b])]
                final_pos[b, : natoms[b]] = r.pos
                final_energy[b] = r.energy
            return final_pos, final_energy

        self._relax_batches(enumerate(self.relax_batcher), relaxed, split, skip_repeats=True)
