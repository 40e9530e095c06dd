"""Plain torch reference of ``X.T @ X``; imports nothing of the program.

``solve`` sums the gram of X's rows a block at a time, over the ranks on
the mesh: ``"float64"`` in float64 (the reference); ``"fp8"`` of X
rounded to float8_e4m3fn, the configuration's bf16 operands one step
down, summed in float64 (the control).

``gaps`` is the number compared: max|G − G_ref| / max|G_ref|.
"""

import torch

ROWS = 1 << 18


def solve(ctx, inputs, k, precision):
    x = inputs["x"]
    d = x.shape[1]
    g = torch.zeros((d, d), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], ROWS):
        xb = x[i:i + ROWS].double()
        if precision == "fp8":
            xb = xb.to(torch.float8_e4m3fn).double()
        elif precision != "float64":
            raise ValueError(precision)
        g += xb.T @ xb
    return ctx.reduce(g)


def at(g):
    """The answer ``solve`` gives: G."""
    return g


def gaps(answer, ref):
    scale = float(ref.abs().max())
    return {"gram_gap": float((answer.double().to(ref.device) - ref)
                              .abs().max()) / scale}
