"""The ``random`` table of tests/test_torch_mesh_random*.py: the random
layer of the port's mesh and the linear algebra that still copied a
sharded operand whole, each entry run through the port's mesh (4 gloo
processes of ``mesh_pool``, the whole table in ONE call, every entry under
the gather guard ``torch_parity.refusing_gathers`` and the drawn-whole
guard ``refusing_whole_draws``), nums_tpu's mesh (the 8 virtual CPU
devices) and the port's serial backend.

Each entry's name starts with what it holds:

* CM10: ``shuffle`` of a sharded array, which crashed (``x.data[order]``
  mixed a tensor with a DTensor): the application's and the facade's;
* CM11: ``choice`` from a sharded pool, which crashed the same way: with
  and without replacement, with ``p``, into a sharded result;
* ``draw_<sampler>``: every sampler of ``NumsRandomState`` on a sharded
  grid, the looped ones (Poisson, binomial and what is built on them) on
  every operand, the permutation, ``choice`` of a range and the facade's
  ``permutation(X)``; ``draw_tiny_<sampler>``: looped draws with
  per-element parameters whose boxes hold one element;
* ``la_<name>``: ``linalg.pinv``, ``inner``, ``cov``/``corrcoef`` with
  ``rowvar=True`` (the (n, n) products by summa's ring), ``diag`` of a
  sharded vector and ``diagflat``.

The operands: ``even``, 1000×8 in (250, 8) blocks; ``uneven``, 1003×7 in
(126, 7) blocks; ``cols``, 1000×8 in (250, 4) blocks, whose columns the
(2, 2) mesh shards too. A draw is held to the serial port bit for bit and
to the reference's mesh at its class in tests/test_torch_random.py's
``DISTS`` (the ``CLASS`` of each entry; ``negative_binomial`` keeps its
known departure, the law alone); the linear algebra at ``LA_TOLS`` (as
max|got − ref| / max|ref|). The reference's mesh compiles each draw anew
(most of a file's time), so it is asked for a part of the table on each
mesh (``reference_names``): on (4, 1) the entries of the uneven operand
and those of no operand, on (2, 2) those of the cols operand and the
linear algebra. Every entry is held to the serial port, which
tests/test_torch_random.py holds to the reference.
"""

import numpy as np

from torch_parity import (
    WHOLE_LIMIT, assert_draw_class, assert_gathers_allowed, jax_mesh_values,
    mesh_app, run_table,
)
from mesh_core_tables import assert_close


def _rs(seed):
    return np.random.RandomState(seed)


X8 = _rs(60).randn(1000, 8)
X7 = _rs(61).randn(1003, 7)
V = _rs(62).randn(1003)


def _p(n):
    """Choice weights of n items, rising with the position."""
    w = np.arange(1.0, n + 1.0)
    return w / w.sum()

OPERANDS = (("even", (1000, 8), (250, 8)), ("uneven", (1003, 7), (126, 7)),
            ("cols", (1000, 8), (250, 4)))
DATA = {"even": X8, "uneven": X7, "cols": X8}

# (sampler, its parameters): the class each is held to against the
# reference is its (name, parameters) entry of tests/test_torch_random.py
# DISTS.
LOOPED = [("poisson", (4.0,)), ("poisson", (50.0,)),
          ("binomial", (20, 0.3)), ("binomial", (200, 0.4)),
          ("negative_binomial", (5.0, 0.4)),
          ("noncentral_chisquare", (0.5, 2.0)),
          ("noncentral_chisquare", (3.0, 2.0)),
          ("noncentral_f", (5.0, 7.0, 2.0))]
POSITION_WISE = [
    ("random", ()), ("uniform", (-2.0, 3.5)), ("normal", (1.0, 2.0)),
    ("standard_normal", ()), ("exponential", (2.0,)),
    ("standard_exponential", ()), ("gumbel", (0.5, 2.0)),
    ("laplace", (0.5, 2.0)), ("logistic", (0.5, 2.0)),
    ("lognormal", (0.1, 0.5)), ("pareto", (3.0,)), ("power", (2.5,)),
    ("weibull", (1.5,)), ("rayleigh", (2.0,)), ("standard_cauchy", ()),
    ("triangular", (-1.0, 0.5, 2.0)), ("geometric", (0.3,)),
    ("logseries", (0.6,)), ("vonmises", (0.5, 2.0)), ("zipf", (2.5,)),
    ("gamma", (2.5, 1.5)), ("standard_gamma", (4.0,)),
    ("chisquare", (0.5,)), ("beta", (2.0, 3.0)), ("f", (5.0, 7.0)),
    ("standard_t", (5.0,)), ("wald", (1.5, 2.0)),
    ("hypergeometric", (20, 10, 10))]

# The tolerances of the linear algebra, against the reference's mesh and
# the serial port (arithmetic of another order: TSQR against an SVD, a
# ring of products against one product).
ARITH = 1e-12
LA_TOLS = {"pinv": 1e-11, "inner": ARITH, "cov": ARITH, "corrcoef": ARITH,
           "diag": 0.0, "diagflat": 0.0}


def _tag(args):
    return "-".join(str(a) for a in args)


def random_table():
    t, kinds = [], {}

    def add(name, fn, kind):
        t.append((name, fn))
        kinds[name] = kind

    for tag, shape, bs in OPERANDS:
        x = DATA[tag]

        def shuffled(app, nps, x=x, bs=bs):
            a = app.array(x, block_shape=bs)
            app.random_state(5).shuffle(a)
            return a

        def facade_shuffled(app, nps, x=x, bs=bs):
            a = app.array(x, block_shape=bs)
            nps.random.RandomState(6).shuffle(a)
            return a

        add(f"CM10_shuffle_{tag}", shuffled, ("draw", "exact"))
        add(f"CM10_nps_shuffle_{tag}", facade_shuffled, ("draw", "exact"))
        for replace in (True, False):
            rep = "replace" if replace else "norep"
            add(f"CM11_choice_{rep}_{tag}", lambda app, nps, x=x, bs=bs,
                replace=replace: app.random_state(7).choice(
                    app.array(x, block_shape=bs), shape=(500,),
                    block_shape=(125, bs[1]), replace=replace),
                ("draw", "exact"))
            add(f"CM11_choice_p_{rep}_{tag}", lambda app, nps, x=x, bs=bs,
                replace=replace: app.random_state(8).choice(
                    app.array(x, block_shape=bs), shape=(300,),
                    block_shape=(75, bs[1]), replace=replace,
                    p=_p(x.shape[0])),
                ("draw", "exact"))
        add(f"CM11_nps_choice_{tag}", lambda app, nps, x=x, bs=bs:
            nps.random.RandomState(9).choice(app.array(x, block_shape=bs),
                                             400), ("draw", "exact"))
        add(f"draw_nps_permutation_{tag}", lambda app, nps, x=x, bs=bs:
            nps.random.RandomState(10).permutation(
                app.array(x, block_shape=bs)), ("draw", "exact"))
        for name, args in LOOPED:
            add(f"draw_{name}_{_tag(args)}_{tag}", lambda app, nps,
                name=name, args=args, shape=shape, bs=bs: getattr(
                    app.random_state(11), name)(*args, shape=shape,
                                                block_shape=bs),
                ("draw", (name, args)))
    for name, args in POSITION_WISE:
        add(f"draw_{name}_{_tag(args)}", lambda app, nps, name=name,
            args=args: getattr(app.random_state(12), name)(
                *args, shape=(1003, 7), block_shape=(126, 7)),
            ("draw", (name, args)))
    add("draw_integers", lambda app, nps: app.random_state(13).integers(
        -5, 90, shape=(1003, 7), block_shape=(126, 7)), ("draw", "exact"))
    add("draw_permutation", lambda app, nps: app.random_state(14).permutation(
        1003, 126), ("draw", "exact"))
    add("draw_permutation_70000", lambda app, nps: app.random_state(
        14).permutation(70_000, 9000), ("draw", "exact"))
    for replace in (True, False):
        rep = "replace" if replace else "norep"
        add(f"draw_choice_range_{rep}", lambda app, nps, replace=replace:
            app.random_state(15).choice(1003, shape=(600,),
                                        block_shape=(75,), replace=replace),
            ("draw", "exact"))
        add(f"draw_choice_range_p_{rep}", lambda app, nps, replace=replace:
            app.random_state(16).choice(1000, shape=(300,),
                                        block_shape=(75,), replace=replace,
                                        p=_p(1000)), ("draw", "exact"))
    add("draw_multinomial", lambda app, nps: app.random_state(17).multinomial(
        20, [1.0 / 16] * 16, shape=(1003,), block_shape=(126, 16)),
        ("draw", "looped"))
    add("draw_multinomial_cols", lambda app, nps: app.random_state(
        17).multinomial(200, [0.1, 0.2, 0.3, 0.4], shape=(1003,),
                        block_shape=(126, 2)), ("draw", "looped"))
    # One-element boxes of looped draws with per-element parameters
    # (negative_binomial's rates from a gamma draw, multinomial's
    # remainders and ratios): (13,) in (4,) blocks, boxes of 4, 4, 4 and
    # 1 rows on (4, 1); (2, 2) in (1, 1) blocks, one element a process on
    # (2, 2). Every process makes each round's all-reduce.
    for shape, bs in (((13,), (4,)), ((2, 2), (1, 1))):
        add(f"draw_tiny_negative_binomial_{_tag(shape)}", lambda app, nps,
            shape=shape, bs=bs: app.random_state(20).negative_binomial(
                5.0, 0.4, shape=shape, block_shape=bs), ("draw", "exact"))
        add(f"draw_tiny_multinomial_{_tag(shape)}", lambda app, nps,
            shape=shape, bs=bs: app.random_state(21).multinomial(
                200, [0.1, 0.2, 0.3, 0.4], shape=shape,
                block_shape=bs + (4,)), ("draw", "exact"))
    add("draw_multivariate_normal", lambda app, nps: app.random_state(
        18).multivariate_normal([1.0, -2.0, 0.5], [[2.0, 0.3, 0.1],
                                                   [0.3, 1.0, 0.2],
                                                   [0.1, 0.2, 0.5]],
                                shape=(1003,), block_shape=(126, 3)),
        ("draw", "looped"))
    add("draw_dirichlet", lambda app, nps: app.random_state(19).dirichlet(
        [0.5, 2.0, 3.0, 0.2], shape=(1003,), block_shape=(126, 4)),
        ("draw", "looped"))
    for tag, _, bs in OPERANDS:
        x = DATA[tag]
        add(f"la_pinv_{tag}", lambda app, nps, x=x, bs=bs: nps.linalg.pinv(
            app.array(x, block_shape=bs)), ("la", "pinv"))
        add(f"la_inner_{tag}", lambda app, nps, x=x, bs=bs: nps.inner(
            app.array(x, block_shape=bs), app.array(x, block_shape=bs)),
            ("la", "inner"))
        add(f"la_cov_{tag}", lambda app, nps, x=x, bs=bs: nps.cov(
            app.array(x, block_shape=bs)), ("la", "cov"))
        add(f"la_corrcoef_{tag}", lambda app, nps, x=x, bs=bs: nps.corrcoef(
            app.array(x, block_shape=bs), rowvar=True), ("la", "corrcoef"))
    add("la_diag_vector", lambda app, nps: nps.diag(app.array(
        V, block_shape=(126,))), ("la", "diag"))
    for k in (0, 3, -2):
        add(f"la_diagflat_vector_{k}", lambda app, nps, k=k: nps.diagflat(
            app.array(V, block_shape=(126,)), k), ("la", "diagflat"))
    add("la_diagflat_matrix", lambda app, nps: nps.diagflat(app.array(
        X7[:200], block_shape=(50, 7))), ("la", "diagflat"))
    return t, kinds


TABLE, KINDS = random_table()


def names():
    return [name for name, _ in TABLE]


# -- the drawn-whole guard --------------------------------------------------


def refusing_whole_draws(record):
    """Patch ``random_ops`` so that a draw of the whole logical shape is
    recorded in ``record``: a bits draw (``_flat_draw``, under every
    uniform, normal and integer draw) or a gamma draw whose positions are
    every position of an array of more than ``WHOLE_LIMIT`` elements, and
    any ``jr_permutation_indices`` of more than ``WHOLE_LIMIT`` items. On a
    sharded grid no process draws the whole array to keep a shard of it.
    Returns the undo."""
    from nums_tpu_torch.core.ops import random_ops

    orig = {name: getattr(random_ops, name) for name in (
        "_flat_draw", "jr_gamma", "jr_permutation_indices")}

    def size(shape):
        return int(np.prod(tuple(shape), dtype=np.int64))

    def flat_draw(key, shape, dtype, device, width, transform, flat_range,
                  chunk, runs=None):
        n = size(shape)
        if flat_range is not None:
            drawn = int(flat_range[1]) - int(flat_range[0])
        elif runs is not None:
            drawn = int(runs[0].numel()) * int(runs[1])
        else:
            drawn = n
        if drawn == n > WHOLE_LIMIT:
            record.append(f"drew the whole {tuple(shape)}")
        return orig["_flat_draw"](key, shape, dtype, device, width,
                                  transform, flat_range, chunk, runs)

    def jr_gamma(key, shape, dtype, device, a, log_space=False, **where):
        if not where and size(shape) > WHOLE_LIMIT:
            record.append(f"drew the whole gamma {tuple(shape)}")
        return orig["jr_gamma"](key, shape, dtype, device, a, log_space,
                                **where)

    def jr_permutation_indices(key, n, device):
        if int(n) > WHOLE_LIMIT:
            record.append(f"drew the whole permutation of {int(n)}")
        return orig["jr_permutation_indices"](key, n, device)

    random_ops._flat_draw = flat_draw
    random_ops.jr_gamma = jr_gamma
    random_ops.jr_permutation_indices = jr_permutation_indices

    def undo():
        for name, fn in orig.items():
            setattr(random_ops, name, fn)

    return undo


def port_values(cluster):
    """In a mesh worker: the table on the port's mesh of ``cluster``,
    each entry under both guards; returns ``run_table``'s (values,
    placed) and the whole draws each entry made (on any process)."""
    import torch.distributed as dist

    import nums_tpu_torch.numpy as nps

    app = mesh_app(cluster)
    drawn = {}
    table = []
    for name, fn in TABLE:
        def guarded(app, nps, name=name, fn=fn):
            record = []
            undo = refusing_whole_draws(record)
            try:
                return fn(app, nps)
            finally:
                undo()
                drawn[name] = record
        table.append((name, guarded))
    values, placed = run_table(app, nps, table, placed=True)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, drawn)
    drawn = {k: sorted({d for w in every for d in w.get(k, [])})
             for k in drawn}
    return values, placed, drawn


# The entries whose one result is one block by the grid the facade gives it
# (``nps.random.choice`` of a shape and no blocks, the reference's layout
# too), drawn from a pool whose columns are sharded: the rows come by one
# pull, and the result's column pieces are then copied whole, the result
# alone: name -> its shape.
RESULT_WHOLE = {"CM11_nps_choice_cols": (400, 8)}


def reference_names(cluster):
    """The entries held to the reference's mesh of ``cluster`` (a
    ``draw_tiny_`` entry, of a dozen elements, to the serial port alone:
    its class is a law or a share of the elements)."""
    if tuple(cluster) == (4, 1):
        return [n for n in names() if not n.endswith(("_even", "_cols"))
                and not n.startswith("draw_tiny_")]
    return [n for n in names() if n.endswith("_cols") or n.startswith("la_")]


def reference_values(cluster):
    keep = set(reference_names(cluster))
    return jax_mesh_values(cluster, [e for e in TABLE if e[0] in keep])


def _bits(value):
    value = np.ascontiguousarray(value)
    return value.view(np.uint8) if value.size else value


def check(port_mesh, reference_mesh, port_serial, name):
    """One entry: the same exception as the serial port, or a value equal
    to it (a draw bit for bit, the linear algebra within its tolerance)
    and to the reference's mesh within its class or tolerance; laid out as
    ``app.array`` lays it; no gather and no whole draw."""
    from test_torch_random import DISTS

    values, placed, drawn = port_mesh
    got, serial = values[name], port_serial[name]
    ref = reference_mesh.get(name)
    kind, what = KINDS[name]
    assert got[1] is None, got[1]
    if kind == "draw":
        g, s = np.asarray(got[0]), np.asarray(serial[0])
        assert g.dtype == s.dtype and g.shape == s.shape, (g.dtype, s.dtype)
        assert np.array_equal(_bits(g), _bits(s))
        cls = what if isinstance(what, str) else {
            (d[0], d[1]): d[2] for d in DISTS}[what]
        if ref is not None:
            # (negative_binomial's class is its known departure: the law
            # alone, mean n(1-p)/p and variance n(1-p)/p^2 for (5, 0.4))
            assert_draw_class(cls, g, np.asarray(ref[0]), "float64")
    else:
        assert_close(got, serial, LA_TOLS[what])
        if ref is not None:
            assert_close(got, ref, LA_TOLS[what])
    where, gathered = placed[name]
    assert where, "a result is not laid out as app.array lays it"
    if name in RESULT_WHOLE:
        gathered = [g for g in gathered
                    if g != f"reboxed a sharded {RESULT_WHOLE[name]} whole"]
    assert_gathers_allowed(name, gathered)
    assert not drawn[name], drawn[name]
