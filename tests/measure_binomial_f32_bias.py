"""The mean of binomial(100, 0.3) drawn at float32 by jax's BTRS (x64 off)
and by the port's CPU route in the accelerator mode, on the CPU: the
offset that the reference's algorithm itself has at float32, which
``chip_smoke.MR_F32_BIAS`` allows beside phase 20's standard errors.
Not a test (pytest does not collect it): run it by hand,

    JAX_PLATFORMS=cpu python tests/measure_binomial_f32_bias.py jax
    python tests/measure_binomial_f32_bias.py port

each printing one JSON line: the mean, its z against 30 and the draws."""

import json
import os
import sys

import numpy as np

CHUNKS, CHUNK = 8, 25_000_000  # 2e8 draws, 25M at a time
N, P, SEED = 100.0, 0.3, 77


def jax_mean():
    import jax
    import jax.numpy as jnp
    import jax.random as jr

    jax.config.update("jax_platforms", "cpu")
    total = 0.0
    for c in range(CHUNKS):
        x = np.asarray(jr.binomial(jr.fold_in(jr.key(SEED), c + 1), N, P,
                                   shape=(CHUNK,), dtype=jnp.float32))
        total += float(x.astype(np.float64).sum())
    return total / (CHUNKS * CHUNK)


def port_mean():
    import torch

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from nums_tpu_torch.core.ops import random_ops, threefry

    total = 0.0
    for c in range(CHUNKS):
        key = threefry.fold_in(threefry.seed_key(SEED, False), c + 1)
        x = random_ops.sample("binomial", key, (CHUNK,), torch.float32,
                              "cpu", False, N, P)
        total += float(x.to(torch.float64).sum())
    return total / (CHUNKS * CHUNK)


if __name__ == "__main__":
    which = sys.argv[1]
    mean = {"jax": jax_mean, "port": port_mean}[which]()
    n = CHUNKS * CHUNK
    print(json.dumps({"route": which, "mean": mean, "draws": n,
                      "z": (mean - N * P) / np.sqrt(N * P * (1 - P) / n)}))
