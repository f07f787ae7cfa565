"""The benchmark tree + wildcard run selection.

gearshifft materializes every (client / precision / extents / kind)
combination as a node and selects nodes with patterns like
``'*/float/*/Inplace_Real'``; the same four-level path layout and
fnmatch-style wildcards here.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Iterable, Sequence, Type

from .client import KINDS, PRECISIONS, Problem
from .extents import classify, format_extents


@dataclass(frozen=True)
class BenchNode:
    """One leaf: a client class bound to a fully specified problem."""

    client_cls: Type
    problem: Problem

    @property
    def path(self) -> str:
        p = self.problem
        return "/".join([self.client_cls.title, p.precision,
                         format_extents(p.extents), p.kind])

    @property
    def extent_class(self) -> str:
        return classify(self.problem.extents)


def build_tree(client_classes: Sequence[Type],
               extents_list: Iterable[tuple[int, ...]],
               kinds: Sequence[str] = KINDS,
               precisions: Sequence[str] = PRECISIONS,
               batch: int = 1) -> list[BenchNode]:
    extents_list = list(extents_list)
    nodes = []
    for cls in client_classes:
        for prec in precisions:
            for ext in extents_list:
                for kind in kinds:
                    nodes.append(BenchNode(cls, Problem(tuple(ext), kind, prec, batch)))
    return nodes


def select(nodes: Sequence[BenchNode], pattern: str | None) -> list[BenchNode]:
    """Filter by a '/'-separated wildcard pattern (missing levels = '*')."""
    if not pattern:
        return list(nodes)
    parts = pattern.split("/")
    parts += ["*"] * (4 - len(parts))
    out = []
    for node in nodes:
        levels = node.path.split("/")
        if all(fnmatch.fnmatch(lv, pat) for lv, pat in zip(levels, parts)):
            out.append(node)
    return out
