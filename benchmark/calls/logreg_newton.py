"""One call: a logistic regression fitted by Newton's method through the
program's entry, ``LogisticRegression(**fit).fit(X, y)``, on one
resident X; the traffic's input set picks the label vector.

The inputs are plain tensors made on the device from the seed: X ~ N(0, 1)
of ``rows`` x ``features`` float32 (on the mesh each rank its own rows, from
its own stream), and for each input set a planted β ~ N(0, σ²) (one stream
shared by the ranks) and labels y = (σ(Xβ) > u), u uniform.
"""

from benchmark.harness import program, roofline, seeding

LABEL_ROWS = 1 << 18   # rows a block when the labels are worked out
PROBE_STEPS = (1, 2)


def make_inputs(ctx):
    torch, dev, cfg = ctx.torch, ctx.device, ctx.config
    n, d, k = cfg["rows"], cfg["features"], ctx.input_sets
    r0, r1 = program.rows_of(n, ctx.world, ctx.rank)
    own = seeding.generator(torch, dev, ctx.seed,
                            seeding.rank_stream(ctx.rank))
    shared = seeding.generator(torch, dev, ctx.seed, seeding.SHARED)
    x = torch.empty((r1 - r0, d), dtype=torch.float32, device=dev)
    x.normal_(generator=own)
    u = torch.rand((k, r1 - r0), dtype=torch.float32, device=dev,
                   generator=own)
    beta = torch.empty((d, k), dtype=torch.float64, device=dev)
    beta.normal_(0.0, cfg["planted_beta_std"], generator=shared)
    y = torch.empty((k, r1 - r0), dtype=torch.float32, device=dev)
    for i in range(0, r1 - r0, LABEL_ROWS):
        p = torch.sigmoid(x[i:i + LABEL_ROWS].double() @ beta).T
        y[:, i:i + LABEL_ROWS] = (p > u[:, i:i + LABEL_ROWS]).float()
    return {"x": x, "y": y, "n": n}


def bind(ctx, inputs):
    from nums_tpu_torch.models.glms import LogisticRegression

    n = inputs["n"]
    return {"X": program.row_array(ctx.app, inputs["x"], n),
            "ys": [program.row_array(ctx.app, y, n) for y in inputs["y"]],
            "model": LogisticRegression, "fit": dict(ctx.config["fit"])}


def call(state, k):
    return state["model"](**state["fit"]).fit(state["X"], state["ys"][k])


def probe(state, k):
    """{m: β} of the same fit on the same X and label vector stopped
    after m steps, for each m of ``PROBE_STEPS``, read once the window
    has closed. The fit's own answer is the point where g = 0 and hardly
    depends on H; after one step β depends on H, after two also on H at
    a β ≠ 0, which a fit that kept its first H would get wrong."""
    return {m: answer(state, state["model"](**dict(state["fit"], max_iter=m))
                      .fit(state["X"], state["ys"][k]))
            for m in PROBE_STEPS}


def answer(state, model):
    """β with the intercept last, whole on this process."""
    import torch

    return torch.cat([program.whole(model.coef_.data).reshape(-1),
                      program.whole(model.intercept_.data).reshape(1)])


def work(cfg):
    """One fit's work: X read once in fp32, y read, β written; each
    iteration the Hessian's upper triangle (intercept column included)
    on the tensor cores, η's and g's 4·n·(d + 1) on the f32 units."""
    n, d, iters = cfg["rows"], cfg["features"], cfg["fit"]["max_iter"]
    da = d + 1
    return {"bytes": 4.0 * n * d + 4.0 * n + 4.0 * da,
            "tc_flops": iters * roofline.triangle_flops(n, da),
            "f32_flops": iters * 4.0 * n * da}
