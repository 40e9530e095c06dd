"""Random sampling on torch generators.

Counterpart of ``nums_tpu/core/ops/random_ops.py`` for the distributions
the main path uses. Every sample is drawn as ONE whole array at the
logical shape from a generator that lives on the backend's device, so a
seed gives the same array whatever the block shape (the reference gets
this from threefry's counters). Torch's generators do not reproduce
threefry's bits: tests feed both packages numpy inputs instead.
"""

import torch


def sample(dist_name: str, shape: tuple, dtype: torch.dtype, device,
           generator: torch.Generator, *params):
    """Draw ``dist_name`` in place into a new tensor (no temporaries:
    a 2.5M x 1000 normal is 10 GB on its own)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if dist_name == "random":
        return out.uniform_(0.0, 1.0, generator=generator)
    if dist_name == "uniform":
        low, high = params
        return out.uniform_(low, high, generator=generator)
    if dist_name == "normal":
        loc, scale = params
        return out.normal_(loc, scale, generator=generator)
    raise NotImplementedError(f"distribution {dist_name!r} is not ported")


def integers(shape: tuple, dtype: torch.dtype, device,
             generator: torch.Generator, low: int, high: int,
             endpoint: bool):
    """Integers in [low, high), or [low, high] with ``endpoint``."""
    if endpoint:
        high = high + 1
    return torch.randint(low, high, tuple(shape), generator=generator,
                         dtype=dtype, device=device)
