"""Tasks and the trainer context: the thin dispatch layer (port of
:mod:`adsorbdiff_tpu.tasks`: ``train``, ``validate``, ``predict`` and
``run-relaxations``)."""
from __future__ import annotations

import contextlib
import logging
import os
from types import SimpleNamespace

import numpy as np

from adsorbdiff_tpu_torch.common.compile_cache import setup_compilation_cache
from adsorbdiff_tpu_torch.common.registry import registry
from adsorbdiff_tpu_torch.train import trainer  # noqa: F401  (registers the trainers)


class BaseTask:
    def __init__(self, config: dict) -> None:
        self.config = config

    def setup(self, trainer) -> None:
        self.trainer = trainer
        if self.config.get("checkpoint"):
            self.trainer.load_checkpoint(self.config["checkpoint"])

    def run(self) -> None:
        raise NotImplementedError


@registry.register_task("train")
class TrainTask(BaseTask):
    def run(self) -> None:
        self.trainer.train(disable_eval_tqdm=self.config.get("hide_eval_progressbar", False))


@registry.register_task("predict")
class PredictTask(BaseTask):
    """EMA predictions over the validation set (else the relax set), written
    to ``results_dir/predictions.npz`` as JAX writes them: ``ids``
    ``"{sid}_{fid}"`` per batch row and ``outputs`` ``[rows, N, 3]`` in f16,
    the translation scores of a denoising trainer or the forces of an S2EF
    trainer (a padded batch repeats its last system)."""

    def run(self) -> None:
        batcher = self.trainer.val_batcher or self.trainer.relax_batcher
        if batcher is None:
            raise ValueError("no dataset to predict on (dataset.1 or task.relax_dataset)")
        ids, outs = [], []
        for batch in batcher:
            if hasattr(self.trainer, "predict_denoising"):
                out, _ = self.trainer.predict_denoising(batch)
            else:
                _, out = self.trainer.predict(batch)
            outs.append(out.cpu().numpy().astype(np.float16))
            ids.extend(f"{s}_{f}" for s, f in zip(batch.sid.tolist(), batch.fid.tolist()))
        path = os.path.join(self.trainer.results_dir, "predictions.npz")
        np.savez_compressed(path, ids=np.asarray(ids), outputs=np.concatenate(outs))
        logging.info(f"Writing results to {path}")


@registry.register_task("validate")
class ValidateTask(BaseTask):
    def run(self) -> None:
        self.trainer.validate(split=self.config.get("val_split", "val"))


@registry.register_task("run-relaxations")
class RelaxationTask(BaseTask):
    """The trainer's ``run_relaxations`` over ``task.relax_dataset`` from a
    checkpoint: diffusion sampling (denoising) or L-BFGS (S2EF)."""

    def run(self) -> None:
        if self.trainer.relax_dataset is None:
            raise ValueError("Relax dataset is required for making predictions (task.relax_dataset)")
        if not self.config.get("checkpoint"):
            raise ValueError("checkpoint required to run relaxations")
        self.trainer.run_relaxations()


@contextlib.contextmanager
def new_trainer_context(config: dict):
    """Build ``(config, task, trainer)`` from a run config; the trainer runs
    on the CUDA card, or on the host when ``config["cpu"]`` is set.
    ``compilation_cache_dir`` picks where the compiled libraries persist
    (:func:`~adsorbdiff_tpu_torch.common.compile_cache.setup_compilation_cache`)."""
    setup_compilation_cache(config.get("compilation_cache_dir"))
    trainer_cls = registry.get_trainer_class(config.get("trainer", "denoising"))
    trainer_obj = trainer_cls(config)
    task = registry.get_task_class(config.get("mode", "train"))(config)
    task.setup(trainer_obj)
    yield SimpleNamespace(config=config, task=task, trainer=trainer_obj)
