"""Shared plug-board resolution for name-keyed strategy registries.

`core/binpacker.py select_binpacker` and the policy window-ordering
plug-board both map a config string to an implementation; both now resolve
through this helper so an unknown name fails the same way everywhere: a
`UnknownStrategyError` listing the valid names, instead of the reference's
silent fall-back to a default (binpack.go:47-54) which hid typos in
production config for years.
"""

from __future__ import annotations

from typing import Mapping, TypeVar

T = TypeVar("T")


class UnknownStrategyError(ValueError):
    """Raised when a config string names no registered strategy."""

    def __init__(self, kind: str, name: str, valid: list[str]):
        self.kind = kind
        self.name = name
        self.valid = valid
        super().__init__(
            f"unknown {kind} {name!r}; valid {kind}s: {', '.join(valid)}"
        )


def resolve(name: str, registry: Mapping[str, T], kind: str) -> T:
    """Look `name` up in `registry`, raising a listing error on a miss."""
    try:
        return registry[name]
    except KeyError:
        raise UnknownStrategyError(kind, name, sorted(registry)) from None
