"""Tasks and the trainer context: the thin dispatch layer (port of
:mod:`adsorbdiff_tpu.tasks`, the ``train`` and ``validate`` tasks)."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

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


@registry.register_task("validate")
class ValidateTask(BaseTask):
    def run(self) -> None:
        self.trainer.validate(split=self.config.get("val_split", "val"))


@contextlib.contextmanager
def new_trainer_context(config: dict):
    """Build ``(config, task, trainer)`` from a run config; the trainer runs
    on the CUDA card, or on the host when ``config["cpu"]`` is set."""
    trainer_cls = registry.get_trainer_class(config.get("trainer", "denoising"))
    trainer_obj = trainer_cls(config)
    task = registry.get_task_class(config.get("mode", "train"))(config)
    task.setup(trainer_obj)
    yield SimpleNamespace(config=config, task=task, trainer=trainer_obj)
