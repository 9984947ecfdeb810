"""Trainers: the shared machinery and denoising score training.

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
- losses drain to the host in one read per logging window;
- a model with drop regularisers (EquiformerV2) is built in train mode and
  draws its masks from a per-step dropout generator seeded from
  (seed, step), separate from the noise generator, so the noise does not
  change when drops are on (JAX's ``fold_in(key, 1)``); the EMA copy, which
  validation and score prediction run, is in eval mode and draws nothing.

Not ported (raise ``NotImplementedError``): S2EF training (``S2EFTrainer``),
``amp``, ``grad_accumulation_steps > 1``, ``ReduceLROnPlateau``,
``run_relaxations``, several devices.
"""
from __future__ import annotations

import copy
import inspect
import logging
import math
import os
import time
from typing import Any, Dict, List, Optional, Tuple

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
from adsorbdiff_tpu_torch.train import checkpoint as ckpt
from adsorbdiff_tpu_torch.train.evaluator import Evaluator
from adsorbdiff_tpu_torch.train.loss import denoising_loss
from adsorbdiff_tpu_torch.train.lr import build_lr_schedule
from adsorbdiff_tpu_torch.train.normalizer import Normalizer

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8  # optax.adamw defaults
# reference config keys the models take elsewhere or not at all
_CONFIG_ONLY_KEYS = ("name", "scale_file", "regress_forces", "direct_forces", "use_pbc", "otf_graph")


def _model_from_config(model_cfg: dict, *, mode: Optional[str], device: torch.device,
                       generator: torch.Generator, training: bool = False) -> torch.nn.Module:
    """The configured model; ``training`` builds it in train mode where the
    class has drop regularisers (a ``training`` argument), and the drop-rate
    keys are dropped for a class without them (the JAX trainer's rules)."""
    cfg = {k: v for k, v in model_cfg.items() if k not in _CONFIG_ONLY_KEYS}
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
        for key, what in (("amp", "amp (mixed precision)"), ("num_devices", "several devices")):
            if config.get(key) and not (key == "num_devices" and int(config[key]) <= 1):
                raise NotImplementedError(f"{what} is not ported yet")
        if int(self.optim_cfg.get("grad_accumulation_steps", 1) or 1) > 1:
            raise NotImplementedError("grad_accumulation_steps > 1 is not ported yet")
        if str(self.optim_cfg.get("scheduler", "")) == "ReduceLROnPlateau":
            raise NotImplementedError("the ReduceLROnPlateau scheduler is not ported yet")
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
                                        generator=torch.Generator().manual_seed(self.seed), training=True)
        self._normalizers(config)
        self._optimizer()
        self.initialized = False
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
        ds = self.train_dataset or self.val_dataset
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
        self.train_dataset = self.val_dataset = None
        self.train_batcher = self.val_batcher = None
        if self.task_cfg.get("relax_dataset"):
            raise NotImplementedError("relax_dataset (run_relaxations) is not ported yet")
        if self.optim_cfg.get("atom_budget"):
            raise NotImplementedError("atom-balanced batches (optim.atom_budget) are not ported yet")
        bs = int(self.optim_cfg.get("batch_size", 4))
        eval_bs = int(self.optim_cfg.get("eval_batch_size", bs))
        if not ds_cfg:
            return
        entries = ds_cfg if isinstance(ds_cfg, list) else [ds_cfg]
        if entries[0].get("src"):
            self.train_dataset = ShardDataset(entries[0])
            self.train_batcher = BucketedBatcher(self.train_dataset, bs, seed=self.seed, shuffle=True)
        if len(entries) > 1 and entries[1].get("src"):
            self.val_dataset = ShardDataset(entries[1])
            self.val_batcher = BucketedBatcher(self.val_dataset, eval_bs, seed=self.seed, shuffle=False)

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
        self.lr_schedule = build_lr_schedule({
            **self.optim_cfg,
            "scheduler_params": {
                **(self.optim_cfg.get("scheduler_params", {}) or {}),
                "epochs": self.optim_cfg.get("max_epochs", 1),
            },
        }, n_iter)
        self.weight_decay = float((self.optim_cfg.get("optimizer_params", {}) or {}).get("weight_decay", 0.0))
        clip = self.optim_cfg.get("clip_grad_norm")
        self.clip_grad_norm = float(clip) if clip else None
        self.ema_decay = self.optim_cfg.get("ema_decay")

    # ------------------------------------------------------------ state
    @property
    def params(self) -> List[torch.nn.Parameter]:
        return list(self.model.parameters())

    def init_state(self) -> None:
        """Fresh optimiser state (zero moments, count 0) and EMA = params.
        The EMA lives in an eval-mode copy of the model (:attr:`ema_module`),
        whose parameters the update writes in place."""
        with torch.no_grad():
            self._flat = _flatten_parameters(self.model)
            self.ema_module = copy.deepcopy(self.model).requires_grad_(False).eval()
            self._ema_flat = _flatten_parameters(self.ema_module)
            self._mu_flat = torch.zeros_like(self._flat)
            self._nu_flat = torch.zeros_like(self._flat)
            self.count = torch.zeros((), dtype=torch.int32, device=self.device)
        params = self.params
        self.mu, self.nu = _views(self._mu_flat, params), _views(self._nu_flat, params)
        self.ema = list(self.ema_module.parameters())
        self.initialized = True

    def state_dict(self) -> dict:
        names = [n for n, _ in self.model.named_parameters()]
        params = dict(self.model.named_parameters())
        return {
            "step": self.step,
            "params": {n: params[n].detach() for n in names},
            "ema_params": dict(zip(names, self.ema)),
            "scale_factors": {n: b for n, b in self.model.named_buffers() if n.endswith("scale_factor")},
            "opt_state": {"count": self.count, "mu": dict(zip(names, self.mu)), "nu": dict(zip(names, self.nu))},
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
            self.count.copy_(state["opt_state"]["count"])
        self.step = int(state["step"])

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
        """NaN-masked clip + AdamW + EMA, as optax's chain computes them, on
        the flat buffers."""
        good = torch.isfinite(loss)
        g = torch.cat([x.reshape(-1) for x in grads])
        g = torch.where(good, g, torch.zeros((), dtype=g.dtype, device=g.device))
        grad_norm = torch.sqrt(torch.sum(g * g))
        if self.clip_grad_norm is not None:
            g = torch.where(grad_norm < self.clip_grad_norm, g, (g / grad_norm) * self.clip_grad_norm)

        flat = self._flat
        count_inc = self.count + 1
        step_f = count_inc.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(ADAM_B1, dtype=torch.float32, device=flat.device), step_f)
        bc2 = 1 - torch.pow(torch.tensor(ADAM_B2, dtype=torch.float32, device=flat.device), step_f)
        mu = (1 - ADAM_B1) * g + ADAM_B1 * self._mu_flat
        nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * self._nu_flat
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
        if self.weight_decay:
            update = update + self.weight_decay * flat
        new_flat = flat + (-self.lr_schedule(self.count)) * update

        torch.where(good, new_flat, flat, out=flat)
        torch.where(good, mu, self._mu_flat, out=self._mu_flat)
        torch.where(good, nu, self._nu_flat, out=self._nu_flat)
        torch.where(good, count_inc, self.count, out=self.count)
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

    def run_relaxations(self, split: str = "val") -> None:
        raise NotImplementedError("run_relaxations is not ported yet")


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
        or None)``, the rotation head zeroed on fixed atoms."""
        return self.score_fn(batch)

    def score_fn(self, batch: AtomsBatch, static_graph=None):
        """The EMA model as the sampler calls it: energy conditioning zeroed,
        as the JAX trainer's sampling model (``sampling=True``) does."""
        out = self.ema_module(batch.replace(energy=torch.zeros_like(batch.energy)), static_graph)
        out1, out2 = out if self.so3 else (out, None)
        if out2 is not None:
            out2 = torch.where(batch.fixed[..., None], torch.zeros_like(out2), out2)
        return out1, out2


@registry.register_trainer("s2ef")
@registry.register_trainer("ocp")
@registry.register_trainer("energy")
@registry.register_trainer("forces")
class S2EFTrainer(BaseTrainer):
    """Energy/forces training: not ported yet."""

    name = "s2ef"

    def __init__(self, config: dict, device: DeviceLike = None) -> None:
        raise NotImplementedError("S2EF training is not ported yet")
