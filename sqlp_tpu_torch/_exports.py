"""Lazy re-exports for the package ``__init__``s (PEP 562).

Each ``__init__`` of the port re-exports the names its counterpart in the
JAX package re-exports, but resolves a name only when it is first read:
``models`` and ``sd`` import each other's modules, and ``utils`` imports
both, so eager imports in the ``__init__``s would cycle; and ``import
sqlp_tpu_torch`` stays as cheap as a bare package (no torch, no kernel
build, no device), which the CLI's many short processes pay for.
"""

from __future__ import annotations

import importlib
import sys
from typing import Callable, Dict, List, Sequence, Tuple


def lazy_exports(package: str, table: Dict[str, Sequence[str]]
                 ) -> Tuple[List[str], Callable, Callable]:
    """(``__all__``, ``__getattr__``, ``__dir__``) for ``package``, which
    re-exports ``table``'s names ({module: (name, ...)}); a name is
    imported from its module on first access and cached on the package."""
    where = {name: module for module, names in table.items()
             for name in names}

    def __getattr__(name: str):
        module = where.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(module), name)
        setattr(sys.modules[package], name, value)
        return value

    def __dir__() -> List[str]:
        return sorted(set(vars(sys.modules[package])) | set(where))

    return list(where), __getattr__, __dir__
