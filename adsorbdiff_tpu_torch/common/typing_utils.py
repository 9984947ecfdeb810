"""Typing helpers (ref: adsorbdiff/utils/typing.py:1-18); a copy of
:mod:`adsorbdiff_tpu.common.typing_utils`."""
from __future__ import annotations

from typing import Optional, Type, TypeVar

T = TypeVar("T")


def assert_is_instance(obj, cls: Type[T]) -> T:
    if not isinstance(obj, cls):
        raise TypeError(f"obj is not an instance of cls: obj={obj!r}, cls={cls!r}")
    return obj


def none_throws(x: Optional[T], msg: Optional[str] = None) -> T:
    if x is None:
        raise ValueError(msg or "Unexpected None")
    return x
