"""No JAX in the process that prints the result: the top-level name of
every loaded module (the part before the first dot), compared whole, so
that ``eagle_mpc_tpu_torch`` is not taken for ``eagle_mpc_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "eagle_mpc_tpu", "tools")


def forbidden(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (by default the
    modules loaded in this process)."""
    names = sys.modules if names is None else names
    tops = {n.split(".", 1)[0] for n in names}
    return sorted(tops & set(FORBIDDEN))
