"""Flattening of nested containers of tensors, for checkpoints and audits.

The containers are those `icpx`'s pytrees use: dict (keys sorted, as JAX
flattens them), list, tuple, None (no leaves) and dataclasses such as `SE3`
or `PointCloud` (fields in declaration order; a field holding a string or
a tuple of strings, like `PointCloud.feat_names`, is structure, as a
static field is in JAX). Everything else is a leaf. So leaf i of a tree
here is leaf i of the same tree in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple


def _is_static(v) -> bool:
    return isinstance(v, str) or (isinstance(v, tuple) and bool(v)
                                  and all(isinstance(x, str) for x in v))


def flatten(tree) -> Tuple[List[Tuple[str, Any]], str]:
    """([(path, leaf), ...], structure string). A path reads like JAX's
    ``keystr``: ``['key']``, ``[0]``, ``.field``."""
    leaves: List[Tuple[str, Any]] = []

    def walk(node, path) -> str:
        if node is None:
            return "None"
        if isinstance(node, dict):
            keys = sorted(node)
            inner = ", ".join(f"{k!r}: {walk(node[k], f'{path}[{k!r}]')}" for k in keys)
            return "{" + inner + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(walk(x, f"{path}[{i}]") for i, x in enumerate(node))
            return ("[" + inner + "]") if isinstance(node, list) else ("(" + inner + ")")
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            parts = []
            for f in dataclasses.fields(node):
                v = getattr(node, f.name)
                parts.append(f"{f.name}={v!r}" if _is_static(v)
                             else f"{f.name}={walk(v, f'{path}.{f.name}')}")
            return f"{type(node).__name__}(" + ", ".join(parts) + ")"
        leaves.append((path, node))
        return "*"

    return leaves, walk(tree, "")


def unflatten(like, leaves: List[Any]):
    """`like`'s structure with its leaves replaced, in order, by `leaves`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(x) for x in node]
            if isinstance(node, list):
                return items
            return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            changes = {f.name: build(getattr(node, f.name)) for f in dataclasses.fields(node)
                       if not _is_static(getattr(node, f.name))}
            return dataclasses.replace(node, **changes)
        return next(it)

    return build(like)
