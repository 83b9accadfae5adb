"""Typed environment-variable parsing (counterpart of ``mridc_tpu/utils/env.py``).

Functional parity with reference: mridc/utils/env_var_parsing.py
(``get_env``, ``get_envbool``, ``get_envint``, ``get_envfloat``,
``get_envlist``, ``get_envdict``, ``CoercionError``, ``RequiredSettingMissingError``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, List

__all__ = [
    "CoercionError",
    "RequiredSettingMissingError",
    "get_env",
    "get_envbool",
    "get_envint",
    "get_envfloat",
    "get_envstr",
    "get_envlist",
    "get_envdict",
]


class CoercionError(Exception):
    def __init__(self, key, value, func):
        super().__init__(f"Unable to coerce '{key}={value}' using {func.__name__}.")


class RequiredSettingMissingError(Exception):
    def __init__(self, key):
        super().__init__(f"Required env var '{key}' is missing.")


def _get_env(key: str, default=None, coerce: Callable = lambda x: x, required: bool = False):
    try:
        value = os.environ[key]
    except KeyError:
        if required and default is None:
            raise RequiredSettingMissingError(key) from None
        return default
    try:
        return coerce(value)
    except Exception:
        raise CoercionError(key, value, coerce) from None


def _bool(value) -> bool:
    # reference truth table (env_var_parsing.py:74-87): f/none are falsy,
    # anything else non-None (including "" and "off") is truthy
    if isinstance(value, bool):
        return value
    return value is not None and value.lower() not in ("false", "0", "no", "n", "f", "none")


def get_env(key: str, *default, coerce: Callable = lambda x: x) -> Any:
    if len(default) > 1:
        raise ValueError("Too many default values supplied.")
    if default:
        return _get_env(key, default[0], coerce)
    return _get_env(key, coerce=coerce, required=True)


def get_envbool(key: str, *default) -> bool:
    return get_env(key, *default, coerce=_bool)


def get_envint(key: str, *default) -> int:
    return get_env(key, *default, coerce=int)


def get_envfloat(key: str, *default) -> float:
    return get_env(key, *default, coerce=float)


def get_envstr(key: str, *default) -> str:
    return get_env(key, *default, coerce=str)


def get_envlist(key: str, *default, separator: str = " ") -> List[str]:
    # reference default separator is a SPACE (env_var_parsing.py:177)
    return get_env(key, *default, coerce=lambda x: x.split(separator))


def get_envdict(key: str, *default) -> dict:
    return get_env(key, *default, coerce=json.loads)
