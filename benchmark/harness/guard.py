"""The process's loaded modules against the packages no run may load: JAX
and the JAX package that the program was ported from. Names are compared
by their top-level part, whole, so ``nums_tpu_torch`` passes and
``nums_tpu`` or ``nums_tpu.core`` does not."""

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "nums_tpu"})


def forbidden_loaded(modules=None):
    """Sorted top-level names of ``modules`` (``sys.modules`` by default)
    that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)
