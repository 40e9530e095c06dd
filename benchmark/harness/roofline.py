"""The yardstick's peaks and least times, frozen here so that no change to
the program moves them.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``BF16_TC_FLOPS``,
``F32_FLOPS``, ``_triangle_flops``, ``_bound``, ``_gram_bound``,
``_k3_bound``), returning seconds where those return milliseconds.
The peaks are one H100 SXM's at its 700 W limit (NVIDIA's data sheet,
dense rates).
"""

HBM_BYTES_PER_S = 3.35e12
BF16_TC_FLOPS = 989e12
F32_FLOPS = 67e12      # outside the tensor cores


def triangle_flops(n, d):
    """Multiply-adds x 2 of the gram's upper triangle, its diagonal
    included: the work the operation needs."""
    return 1.0 * n * d * (d + 1)


def bound(bytes_moved, tc_flops, f32_flops=0.0):
    """(seconds, bound_by): the largest of the bytes over the memory rate
    and the operations of each type over that type's peak rate (the
    tensor cores and the f32 units run side by side)."""
    mem_s = bytes_moved / HBM_BYTES_PER_S
    ops_s = max(tc_flops / BF16_TC_FLOPS, f32_flops / F32_FLOPS)
    return max(mem_s, ops_s), "bytes" if mem_s >= ops_s else "operations"


def gram_work(n, d, weighted=False):
    """The gram's work: X (and the weights) read once in fp32, G written
    once, its upper triangle on the tensor cores."""
    return {"bytes": 4.0 * n * d + (4.0 * n if weighted else 0.0)
            + 4.0 * d * d,
            "tc_flops": triangle_flops(n, d), "f32_flops": 0.0}


def newton_stats_work(n, da, x_bytes):
    """One Newton iteration's statistics: X read once at ``x_bytes`` a
    value, y and beta read, g and H written; the gram's triangle on the
    tensor cores, eta's and g's 4·n·d on the f32 units."""
    return {"bytes": x_bytes * n * da + 4.0 * n + 8.0 * da + 4.0 * da * da,
            "tc_flops": triangle_flops(n, da), "f32_flops": 4.0 * n * da}


def least_seconds(work, chips=1):
    """The least time of ``work`` spread evenly over ``chips`` cards."""
    return bound(work["bytes"] / chips, work["tc_flops"] / chips,
                 work["f32_flops"] / chips)
