"""Plain torch reference of the logistic fit; imports nothing of the
program and takes nothing it made.

``solve`` works X with its intercept column out again from the inputs and
runs Newton's method from β = 0 for ``max_iter`` steps (a step whose
gradient is at most ``tol`` is the last, as the program's loop freezes
β), a block of rows at a time, summed over the ranks on the mesh. It
returns β after each step, the last the fit's answer:

- ``"float64"``: the reference, every operand and sum in float64;
- ``"fp8"``: the control, the configuration's precision one step down.
  The program rounds X, β, the residual r and √s to bf16, and the
  Hessian's operand bf16(x)·bf16(√s) again; the control rounds each of
  them to float8_e4m3fn instead (products of such values, summed in
  float64, are what an fp8 product with a wide sum gives).

``gaps`` is the number compared: max|β − β_ref| / max|β_ref|, over the
coefficients and the intercept; ``beta_gap`` for the fit's answer, and
``step<m>_gap`` for the answer of the same fit stopped after m steps (a
probe), held to the reference's β after m steps. The fit's answer is
the point where g = 0 and hardly depends on H; a probe's does.
"""

import torch

ROWS = 1 << 18   # rows a block: 2.1 GB of float64 at 1001 columns


def _fp8(t):
    return t.to(torch.float8_e4m3fn).to(t.dtype)


def _stats(xa, y, beta, precision):
    """(g, H) of one block's rows; ``xa`` float64 with the ones column."""
    if precision == "float64":
        mu = torch.sigmoid(xa @ beta)
        return xa.T @ (mu - y), (xa * (mu * (1.0 - mu))[:, None]).T @ xa
    if precision != "fp8":
        raise ValueError(precision)
    xq = _fp8(xa)
    mu = torch.sigmoid(xq @ _fp8(beta))
    r = _fp8(mu - y)
    xs = _fp8(xq * _fp8(torch.sqrt(mu * (1.0 - mu)))[:, None])
    return xq.T @ r, xs.T @ xs


def solve(ctx, inputs, k, precision):
    x, y = inputs["x"], inputs["y"][k]
    fit = ctx.config["fit"]
    n, d = x.shape
    beta = torch.zeros(d + 1, dtype=torch.float64, device=x.device)
    betas = []
    for _ in range(int(fit["max_iter"])):
        g = torch.zeros(d + 1, dtype=torch.float64, device=x.device)
        h = torch.zeros((d + 1, d + 1), dtype=torch.float64, device=x.device)
        for i in range(0, n, ROWS):
            xb = x[i:i + ROWS]
            xa = torch.ones((xb.shape[0], d + 1), dtype=torch.float64,
                            device=x.device)
            xa[:, :d] = xb
            gb, hb = _stats(xa, y[i:i + ROWS].double(), beta, precision)
            g += gb
            h += hb
            del xa
        ctx.reduce(g)
        ctx.reduce(h)
        beta = beta - torch.linalg.solve(h, g)
        betas.append(beta)
        if float(g.abs().max()) <= fit["tol"]:
            break
    return betas


def at(betas, steps=None):
    """β of ``solve``'s βs after ``steps`` steps, or the fit's answer."""
    return betas[-1 if steps is None else min(steps, len(betas)) - 1]


def gaps(answer, ref, steps=None):
    """{name: gap} of ``answer`` against ``ref`` (``solve``'s βs): the
    fit's, or after ``steps`` steps."""
    name = "beta_gap" if steps is None else f"step{steps}_gap"
    ref = at(ref, steps).double()
    scale = float(ref.abs().max())
    return {name: float((answer.double().to(ref.device) - ref)
                        .abs().max()) / scale}
