"""The import guard: no module of JAX or of the JAX package may be
loaded in the process that prints a result.  Names are compared by
their top-level part (before the first dot) whole, so that the port,
whose name begins with the JAX package's, passes."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "gnuais_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is one of
    ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
