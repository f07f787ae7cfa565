"""Decorator-based client registry of the port.

gearshifft builds one binary per FFT library; here one registered client
class per backend "binary".  Registering the *same* class twice under one
name is a no-op; a *different* class under a taken name is rejected.
"""

from __future__ import annotations

from typing import Callable, Type

_REGISTRY: dict[str, Type] = {}


def register_client(name: str | None = None) -> Callable[[Type], Type]:
    """Class decorator: ``@register_client()`` or ``@register_client("Name")``.
    The name defaults to the class's ``title`` (else ``__name__``)."""

    def deco(cls: Type) -> Type:
        key = name or getattr(cls, "title", None) or cls.__name__
        existing = _REGISTRY.get(key)
        if existing is not None and existing is not cls:
            raise ValueError(
                f"client name {key!r} already registered by "
                f"{existing.__module__}.{existing.__qualname__}")
        _REGISTRY[key] = cls
        return cls

    return deco


def get_client(name: str) -> Type:
    try:
        return _REGISTRY[name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY)) or "<none>"
        raise KeyError(f"unknown client {name!r}; registered: {known}") from None


def client_names() -> list[str]:
    return sorted(_REGISTRY)


def registered_clients() -> dict[str, Type]:
    return dict(_REGISTRY)
