"""One call: ``X.T @ X`` through the program's array facade
(``BlockArray.T`` and ``__matmul__``) on one resident X ~ N(0, 1) of
``rows`` x ``features`` float32, made on the device from the seed (on the
mesh each rank its own rows, from its own stream)."""

from benchmark.harness import program, roofline, seeding


def make_inputs(ctx):
    torch, dev, cfg = ctx.torch, ctx.device, ctx.config
    n, d = cfg["rows"], cfg["features"]
    r0, r1 = program.rows_of(n, ctx.world, ctx.rank)
    own = seeding.generator(torch, dev, ctx.seed,
                            seeding.rank_stream(ctx.rank))
    x = torch.empty((r1 - r0, d), dtype=torch.float32, device=dev)
    x.normal_(generator=own)
    return {"x": x, "n": n}


def bind(ctx, inputs):
    return {"X": program.row_array(ctx.app, inputs["x"], inputs["n"])}


def call(state, k):
    X = state["X"]
    return X.T @ X


def answer(state, G):
    return program.whole(G.data)


def work(cfg):
    return roofline.gram_work(cfg["rows"], cfg["features"])
