"""PyTorch port: profiling, the compile cache and the typing helpers.

``StageTimer.summary`` is held to the JAX package's text for the same
totals; ``trace`` writes its trace on the CPU; ``setup_compilation_cache``
resolves its directory as JAX's does (argument, then
``$ADSORBDIFF_TPU_COMPILE_CACHE``, then the port's ``_build/``), and the
CUDA and host libraries build into it.  Every test puts the module's state back.
"""
import glob
import json
import os

import pytest
import torch

from adsorbdiff_tpu.common import profiling as jax_profiling
from adsorbdiff_tpu.common import typing_utils as jax_typing
from adsorbdiff_tpu_torch import tasks
from adsorbdiff_tpu_torch.common import compile_cache, profiling, typing_utils
from adsorbdiff_tpu_torch.ops import build, host_build
from tests.port_bridge import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture
def fresh_cache(monkeypatch):
    """No directory fixed yet and no environment override; monkeypatch
    restores both."""
    monkeypatch.setattr(compile_cache, "_DIR", None)
    monkeypatch.delenv(compile_cache.ENV, raising=False)


def test_stage_timer_summary_matches_jax():
    got, want = profiling.StageTimer(), jax_profiling.StageTimer()
    for timer in (got, want):
        timer.totals = {"relax": 1.23456, "sample": 7.5, "io": 0.0004}
        timer.counts = {"relax": 3, "sample": 1, "io": 7}
    assert got.summary() == want.summary()
    assert got.summary().splitlines()[0] == "sample: 7.500s total, 7500.0ms avg (1x)"


def test_stage_timer_counts_stages():
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("step", fence_on=torch.ones(2)):
            torch.ones(4).sum()
    with timer.stage("other"):
        pass
    assert timer.counts == {"step": 3, "other": 1}
    assert all(v >= 0 for v in timer.totals.values())
    assert len(timer.summary().splitlines()) == 2


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    logdir = str(tmp_path / "profile")
    with profiling.trace(logdir) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert prof.key_averages()


@pytest.mark.parametrize("how", ["argument", "environment", "default"])
def test_compilation_cache_resolution(fresh_cache, monkeypatch, tmp_path, how):
    explicit, env = str(tmp_path / "explicit"), str(tmp_path / "env")
    if how != "default":
        monkeypatch.setenv(compile_cache.ENV, env)
    want = {"argument": explicit, "environment": env, "default": build.BUILD_DIR}[how]
    got = compile_cache.setup_compilation_cache(explicit if how == "argument" else None)
    assert got == os.path.abspath(want) and os.path.isdir(got)
    # idempotent: later calls return the directory the first one fixed
    assert compile_cache.setup_compilation_cache(str(tmp_path / "other")) == got
    assert compile_cache.setup_compilation_cache() == got
    assert os.path.dirname(build.library_path("painn_message_fused")) == got
    assert os.path.dirname(host_build.library_path("lmdbread")) == got


def test_compilation_cache_empty_path_changes_nothing(fresh_cache, monkeypatch, tmp_path):
    assert compile_cache.setup_compilation_cache("") is None
    assert compile_cache._DIR is None
    assert os.path.dirname(build.library_path("gemnet_quad_chain")) == build.BUILD_DIR
    # the environment alone points both build modules at its directory
    monkeypatch.setenv(compile_cache.ENV, str(tmp_path))
    assert os.path.dirname(build.library_path("gemnet_quad_chain")) == str(tmp_path)
    assert os.path.dirname(host_build.library_path("adshard")) == str(tmp_path)


def test_host_libraries_build_into_the_cache(fresh_cache, tmp_path):
    """``ops/host_build.py`` compiles into the chosen directory
    (``ops/build.py`` shares :func:`compile_cache.cache_dir`; it needs nvcc,
    which the CPU tests go without)."""
    cache = compile_cache.setup_compilation_cache(str(tmp_path / "cache"))
    paths = host_build.build(["lmdbread"])
    assert os.path.dirname(paths["lmdbread"]) == cache and os.path.exists(paths["lmdbread"])
    assert os.listdir(cache) == [os.path.basename(paths["lmdbread"])]


def test_trainer_context_sets_the_cache(fresh_cache, monkeypatch, tmp_path):
    """``compilation_cache_dir`` of a run config picks the directory, as
    JAX's ``new_trainer_context`` does."""
    class Stub:
        def __init__(self, config):
            self.config = config

        def setup(self, trainer):
            pass

    monkeypatch.setattr(tasks.registry, "get_trainer_class", lambda name: Stub)
    monkeypatch.setattr(tasks.registry, "get_task_class", lambda name: Stub)
    with tasks.new_trainer_context({"compilation_cache_dir": str(tmp_path / "runs")}) as ctx:
        assert isinstance(ctx.trainer, Stub)
    assert compile_cache._DIR == str(tmp_path / "runs")


@pytest.mark.parametrize("pkg", [typing_utils, jax_typing], ids=["port", "jax"])
def test_typing_utils(pkg):
    assert pkg.assert_is_instance(3, int) == 3
    with pytest.raises(TypeError, match="obj is not an instance of cls"):
        pkg.assert_is_instance("3", int)
    assert pkg.none_throws(0) == 0
    with pytest.raises(ValueError, match="Unexpected None"):
        pkg.none_throws(None)
    with pytest.raises(ValueError, match="no value"):
        pkg.none_throws(None, "no value")
