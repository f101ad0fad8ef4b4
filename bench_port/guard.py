"""Whole-name guard against the JAX stack: the measured package's name
begins with the JAX package's, so names are compared by their top-level
part, whole."""

from __future__ import annotations

import ast
import os
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "forest_slam_tpu")


def top_level(name: str) -> str:
    return name.split(".")[0]


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is a forbidden one."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top_level(n) in FORBIDDEN)


def imported_names(path: str) -> list:
    """Top-level names of the absolute imports in a Python file."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [top_level(a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append(top_level(node.module))
    return out


def scan(directory: str) -> dict:
    """File -> forbidden top-level names it imports, for every .py below
    ``directory``."""
    bad = {}
    for base, _, files in os.walk(directory):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(base, name)
                hits = sorted(set(imported_names(path)) & set(FORBIDDEN))
                if hits:
                    bad[path] = hits
    return bad
