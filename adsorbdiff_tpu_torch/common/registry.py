"""Global name -> class registry (port of :mod:`adsorbdiff_tpu.common.registry`).

Decorator registration for trainers, models, datasets, loggers and tasks, and
fully-qualified class paths as a fallback, so a config may say
``trainer: denoising`` or name a class by its import path.
"""
from __future__ import annotations

import importlib
from typing import Callable, Dict


def _import_class(path: str) -> type:
    module_name, _, cls_name = path.rpartition(".")
    if not module_name:
        raise ImportError(f"'{path}' is not a fully-qualified class path")
    module = importlib.import_module(module_name)
    try:
        return getattr(module, cls_name)
    except AttributeError as e:
        raise ImportError(f"module '{module_name}' has no class '{cls_name}'") from e


class Registry:
    """Name -> class maps per kind."""

    KINDS = ("task", "dataset", "model", "logger", "trainer")

    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, type]] = {k: {} for k in self.KINDS}

    def _register(self, kind: str, name: str) -> Callable[[type], type]:
        def wrap(cls: type) -> type:
            existing = self._maps[kind].get(name)
            if existing is not None and existing is not cls:
                raise KeyError(f"{kind} '{name}' already registered to {existing!r}")
            self._maps[kind][name] = cls
            return cls

        return wrap

    def register_task(self, name: str):
        return self._register("task", name)

    def register_dataset(self, name: str):
        return self._register("dataset", name)

    def register_model(self, name: str):
        return self._register("model", name)

    def register_logger(self, name: str):
        return self._register("logger", name)

    def register_trainer(self, name: str):
        return self._register("trainer", name)

    def get_class(self, kind: str, name: str) -> type:
        cls = self._maps[kind].get(name)
        if cls is not None:
            return cls
        if "." in name:
            return _import_class(name)
        raise KeyError(f"no {kind} named '{name}' (known: {sorted(self._maps[kind])})")

    def get_task_class(self, name: str) -> type:
        return self.get_class("task", name)

    def get_dataset_class(self, name: str) -> type:
        return self.get_class("dataset", name)

    def get_model_class(self, name: str) -> type:
        return self.get_class("model", name)

    def get_logger_class(self, name: str) -> type:
        return self.get_class("logger", name)

    def get_trainer_class(self, name: str) -> type:
        return self.get_class("trainer", name)


registry = Registry()
