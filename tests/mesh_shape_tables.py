"""The ``shape`` table of tests/test_torch_mesh_shape*.py: the slicing,
shape and order ops of the port's mesh, each entry an op on arrays made
from a seed, run through the port's mesh (4 gloo processes of
``mesh_pool``, the whole table in ONE call, every entry under the gather
guard ``torch_parity.refusing_gathers``), nums_tpu's mesh (the 8 virtual
CPU devices) and the port's serial backend.

Each entry's name starts with the id of the fault that the probe of the
port's mesh found (ROADMAP Queue C):

* C-M6: basic slices along the sharded rows (``X[a:b]``, a step, a
  negative step, ``X[k]``, ``split``/``array_split``);
* C-M7: ops that copied a sharded operand whole through DTensor's own
  strategy: ``sort``/``argsort`` along the rows and flattened,
  ``reshape``/``ravel``, ``concatenate``/``vstack``/``append``,
  ``flip``/``flipud``, ``roll``, ``take``, ``tile``, ``delete``,
  ``tril``/``triu``, ``diff``, ``gradient``, ``trapezoid``, ``unwrap``,
  ``fft``/``rfft`` along the rows, ``cov``/``corrcoef`` of the columns,
  ``resize``;
* C-M8: what crashed where the reference answers (``sort(axis=None)`` of
  uneven shards, ``kron``, ``resize``, ``vander``, ``polyval``);
* C-M9: ``partition``/``argpartition`` along a sharded axis, and the
  distributed sort of a sharded vector (``sort``, ``argsort``,
  ``lexsort``, ``sort_complex``), signed zeros and NaN among the values.

X8 is 1000×8 in (250, 8) blocks (even shards on (4, 1)), X7 1003×7 in
(126, 7) blocks (uneven), X8 in (250, 4) blocks has its columns sharded on
the (2, 2) mesh. ``TOLS[name]`` is the tolerance as max|got − ref| /
max|ref| against the reference's mesh and the serial port; 0 means equal
(a move, a sort, an index: equal), ``BITS`` equal bit for bit (the
sorts' values read as integers, after the entry).
"""

import numpy as np

from torch_parity import (
    assert_gathers_allowed, jax_mesh_values, mesh_app, run_table,
)
from mesh_core_tables import assert_close


def _rs(seed):
    return np.random.RandomState(seed)


X8 = _rs(40).randn(1000, 8)
X7 = _rs(41).randn(1003, 7)
V = _rs(42).randn(1003)
V[::50] = 0.0
V[25::77] = -0.0
V[5::97] = np.nan
V8 = _rs(43).randn(1000)
K = _rs(44).randint(0, 5, size=1003)
C = V + 1j * _rs(45).randn(1003)
C[::31] = C[::31].real + 0j
T = np.linspace(0.0, 3.0, 1003) ** 2
# arithmetic: the reference's XLA (FFT, products, sums in another order)
ARITH = 1e-12
# equal bit for bit (signed zeros and NaN payloads told apart)
BITS = "bits"

OPERANDS = (("even", X8, (250, 8)), ("uneven", X7, (126, 7)),
            ("cols", X8, (250, 4)))


def _a(app, x, bs):
    return app.array(x, block_shape=bs)


def shape_table():
    t, tols = [], {}

    def add(name, fn, tol=0.0):
        t.append((name, fn))
        tols[name] = tol

    for tag, x, bs in OPERANDS:
        def A(app, x=x, bs=bs):
            return _a(app, x, bs)

        n = x.shape[0]
        # C-M6
        add(f"CM6_slice_{tag}", lambda app, nps, A=A: A(app)[100:900])
        add(f"CM6_step_{tag}", lambda app, nps, A=A: A(app)[3::2])
        add(f"CM6_reverse_{tag}", lambda app, nps, A=A: A(app)[::-1])
        add(f"CM6_reverse_step_{tag}", lambda app, nps, A=A: A(app)[
            900:5:-3, 1:6])
        add(f"CM6_row_{tag}", lambda app, nps, A=A: A(app)[5])
        add(f"CM6_row_last_{tag}", lambda app, nps, A=A: A(app)[-1, 2:])
        add(f"CM6_split_{tag}", lambda app, nps, A=A: nps.array_split(
            A(app), 4)[2])
        add(f"CM6_split_all_{tag}", lambda app, nps, A=A: nps.array_split(
            A(app), [10, 600]))
        # C-M7 and C-M8
        add(f"CM7_reshape_{tag}", lambda app, nps, A=A, n=n: A(app).reshape(
            n // 2 if n % 2 == 0 else 17, -1))
        add(f"CM7_ravel_{tag}", lambda app, nps, A=A: nps.ravel(A(app)))
        add(f"CM7_concatenate_{tag}", lambda app, nps, A=A: nps.concatenate(
            [A(app), A(app)[:7]]))
        add(f"CM7_vstack_{tag}", lambda app, nps, A=A: nps.vstack(
            [A(app), A(app)]))
        add(f"CM7_append_{tag}", lambda app, nps, A=A: nps.append(
            A(app), A(app)[:3], axis=0))
        add(f"CM7_flip_{tag}", lambda app, nps, A=A: nps.flip(A(app), 0))
        add(f"CM7_flipud_{tag}", lambda app, nps, A=A: nps.flipud(A(app)))
        add(f"CM7_roll_{tag}", lambda app, nps, A=A: nps.roll(A(app), 123,
                                                              0))
        add(f"CM7_roll_back_{tag}", lambda app, nps, A=A: nps.roll(
            A(app), -1234, 0))
        add(f"CM7_take_{tag}", lambda app, nps, A=A: nps.take(
            A(app), np.array([5, 900, 3, 999, 3]), axis=0))
        add(f"CM7_tile_{tag}", lambda app, nps, A=A: nps.tile(A(app),
                                                              (2, 1)))
        add(f"CM7_delete_{tag}", lambda app, nps, A=A: nps.delete(
            A(app), 500, axis=0))
        add(f"CM7_tril_{tag}", lambda app, nps, A=A: nps.tril(A(app), -2))
        add(f"CM7_triu_{tag}", lambda app, nps, A=A: nps.triu(A(app), 1))
        add(f"CM7_diff_{tag}", lambda app, nps, A=A: nps.diff(A(app),
                                                              axis=0))
        add(f"CM7_diff3_{tag}", lambda app, nps, A=A: nps.diff(
            A(app), n=3, axis=0))
        add(f"CM7_gradient_{tag}", lambda app, nps, A=A: nps.gradient(
            A(app), axis=0))
        add(f"CM7_trapezoid_{tag}", lambda app, nps, A=A: nps.trapezoid(
            A(app), axis=0), ARITH)
        add(f"CM7_unwrap_{tag}", lambda app, nps, A=A: nps.unwrap(
            A(app) * 3.0, axis=0), ARITH)
        add(f"CM7_fft_{tag}", lambda app, nps, A=A: nps.fft.fft(
            A(app), axis=0), ARITH)
        add(f"CM7_rfft_{tag}", lambda app, nps, A=A: nps.fft.rfft(
            A(app), axis=0), ARITH)
        add(f"CM7_cov_{tag}", lambda app, nps, A=A: nps.cov(
            A(app), rowvar=False), ARITH)
        add(f"CM7_corrcoef_{tag}", lambda app, nps, A=A: nps.corrcoef(
            A(app), rowvar=False), ARITH)
        add(f"CM7_sort_rows_{tag}", lambda app, nps, A=A: nps.sort(
            A(app), axis=0), BITS)
        add(f"CM7_argsort_rows_{tag}", lambda app, nps, A=A: nps.argsort(
            A(app), axis=0))
        add(f"CM8_sort_flat_{tag}", lambda app, nps, A=A: nps.sort(
            A(app), axis=None), BITS)
        add(f"CM8_kron_{tag}", lambda app, nps, A=A: nps.kron(
            A(app), np.ones((2, 1))))
        add(f"CM8_resize_{tag}", lambda app, nps, A=A, n=n: nps.resize(
            A(app), (2 * n, x.shape[1])))
        add(f"CM9_partition_rows_{tag}", lambda app, nps, A=A: nps.partition(
            A(app), 3, axis=0))
        add(f"CM9_argpartition_rows_{tag}", lambda app, nps, A=A: (
            nps.argpartition(A(app), 700, axis=0)))
    # the distributed sort of a sharded vector (ties, signed zeros, NaN)
    for tag, v, bs in (("uneven", V, (126,)), ("even", V8, (250,))):
        def B(app, v=v, bs=bs):
            return _a(app, v, bs)

        add(f"CM9_sort_{tag}", lambda app, nps, B=B: nps.sort(B(app)),
            BITS)
        add(f"CM9_argsort_{tag}", lambda app, nps, B=B: nps.argsort(B(app)))
        add(f"CM9_partition_{tag}", lambda app, nps, B=B: nps.partition(
            B(app), 500), BITS)
        add(f"CM9_argpartition_{tag}", lambda app, nps, B=B: (
            nps.argpartition(B(app), 250)))
        add(f"CM9_partition_last_{tag}", lambda app, nps, B=B: (
            nps.partition(B(app), -1)), BITS)
        add(f"CM8_vander_{tag}", lambda app, nps, B=B: nps.vander(B(app), 3),
            ARITH)
        add(f"CM8_polyval_{tag}", lambda app, nps, B=B: nps.polyval(
            nps.array(np.array([1.5, -2.0, 0.5])), B(app)), ARITH)
        add(f"CM7_unwrap_vector_{tag}", lambda app, nps, B=B: nps.unwrap(
            B(app) * 4.0), ARITH)
        add(f"CM7_trapezoid_x_{tag}", lambda app, nps, B=B: nps.trapezoid(
            nps.nan_to_num(B(app)), x=_a(app, T[:B(app).shape[0]], (100,))),
            ARITH)
        add(f"CM7_ediff1d_{tag}", lambda app, nps, B=B: nps.ediff1d(B(app)))
    add("CM9_argsort_ties", lambda app, nps: nps.argsort(_a(app, K, (126,))))
    add("CM9_argpartition_ties", lambda app, nps: nps.argpartition(
        _a(app, K, (126,)), 400))
    add("CM9_lexsort", lambda app, nps: nps.lexsort((
        _a(app, K % 3, (126,)), _a(app, K, (126,)))))
    add("CM9_lexsort_floats", lambda app, nps: nps.lexsort((
        _a(app, V, (126,)), _a(app, K, (126,)))))
    add("CM9_sort_complex", lambda app, nps: nps.sort_complex(
        _a(app, C, (126,))))
    add("CM9_sort_complex_values", lambda app, nps: nps.sort(
        _a(app, C, (126,))))
    # each process orders what it received a few key ranges at a time
    add("CM9_sort_chunked", _chunked(lambda app, nps: nps.sort(
        _a(app, V, (126,)))), BITS)
    add("CM9_argsort_ties_chunked", _chunked(lambda app, nps: nps.argsort(
        _a(app, K, (126,)))))
    add("CM9_lexsort_chunked", _chunked(lambda app, nps: nps.lexsort((
        _a(app, V, (126,)), _a(app, K, (126,))))))
    add("CM9_argpartition_chunked", _chunked(lambda app, nps: (
        nps.argpartition(_a(app, V, (126,)), 600))))
    return t, tols


def _chunked(fn):
    """``fn`` with the port's sample sort ordering 64 elements at a time
    (``mesh_ops.SORT_CHUNK_ELEMENTS``; the reference ignores it)."""
    def run(app, nps):
        from nums_tpu_torch.core.ops import mesh_ops

        saved = mesh_ops.SORT_CHUNK_ELEMENTS
        mesh_ops.SORT_CHUNK_ELEMENTS = 64
        try:
            return fn(app, nps)
        finally:
            mesh_ops.SORT_CHUNK_ELEMENTS = saved
    return run


TABLE, TOLS = shape_table()


def names():
    return [name for name, _ in TABLE]


def port_values(cluster):
    """In a mesh worker: the table on the port's mesh of ``cluster``."""
    import nums_tpu_torch.numpy as nps

    return run_table(mesh_app(cluster), nps, TABLE, placed=True)


def reference_values(cluster):
    return jax_mesh_values(cluster, TABLE)


def _as_bits(entry):
    value, exc = entry
    if value is None:
        return entry
    value = np.asarray(value)
    return value.view(np.int64) if value.dtype == np.float64 else value, exc


def check(port_mesh, reference_mesh, port_serial, name):
    values, placed = port_mesh
    got, tol = values[name], TOLS[name]
    if tol == BITS:
        assert_close(_as_bits(got), _as_bits(reference_mesh[name]), 0.0)
        assert_close(_as_bits(got), _as_bits(port_serial[name]), 0.0)
    else:
        assert_close(got, reference_mesh[name], tol)
        assert_close(got, port_serial[name], tol)
    where, gathered = placed[name]
    assert where, "a result is not laid out as app.array lays it"
    assert_gathers_allowed(name, gathered)


# -- the sweep: every name of the coverage report that takes an array ----

# Names the sweep does not call: they read or write files (the pool's
# processes share a working directory), take shapes or type codes rather
# than an array, or build an array of n² elements from two (kron, outer:
# 8000² for X8). polyval's first operand is its coefficients, which every
# element reads (held to the mesh in CM8_polyval_*, with whole ones).
SWEEP_SKIP = {"fromfile", "fromregex", "genfromtxt", "loadtxt",
              "savez_compressed", "tofile", "nested_iters", "kron",
              "outer", "linalg.outer", "histogramdd", "broadcast_shapes",
              "mintypecode", "ravel_multi_index", "select", "polyval"}
# (the vector has more than ``WHOLE_LIMIT`` elements, so that the guard
# sees a whole copy of it)
SWEEP_OPERANDS = (("even", X8, (250, 8)), ("uneven", X7, (126, 7)),
                  ("vector", V, (126,)))
# The call of a name that takes a sequence of arrays, or an array and a
# count or a position (``fn(X)`` would iterate over X's rows).
_PAIR = ("concatenate", "concat", "hstack", "vstack", "row_stack",
         "column_stack", "dstack", "stack", "block", "lexsort")
SWEEP_FORMS = {**{name: lambda x: ([x, x],) for name in _PAIR},
               "array_split": lambda x: (x, 3), "split": lambda x: (x, 2),
               "vsplit": lambda x: (x, 2), "hsplit": lambda x: (x, 2),
               "pad": lambda x: (x, 2), "expand_dims": lambda x: (x, 0),
               "broadcast_to": lambda x: (x, tuple(x.shape)),
               "tile": lambda x: (x, (2, 1)), "repeat": lambda x: (x, 2),
               "roll": lambda x: (x, 3), "delete": lambda x: (x, 5),
               "insert": lambda x: (x, 5, 0.0),
               "partition": lambda x: (x, 3),
               "argpartition": lambda x: (x, 3),
               "resize": lambda x: (x, (2 * x.shape[0], x.shape[1])),
               "reshape": lambda x: (x, (-1, 1)),
               "meshgrid": lambda x: (x[:, 0], x[:, 1])}


def _sweep_names():
    import nums_tpu_torch.numpy as nps
    from nums_tpu_torch.cmds import api_coverage as cov

    out = []
    for prefix, mod, ours in (("", np, nps),
                              ("linalg.", np.linalg, nps.linalg),
                              ("fft.", np.fft, nps.fft)):
        implemented, fallback, _, _ = cov._module_coverage(mod, ours)
        out.extend(prefix + name for name in sorted(implemented + fallback)
                   if prefix + name not in SWEEP_SKIP)
    return out


def _function(root, name):
    for part in name.split("."):
        root = getattr(root, part)
    return root


def _calls(name):
    """The calls the sweep tries for ``name``, in order, each a function
    of the operand giving the arguments."""
    if name in SWEEP_FORMS:
        return [SWEEP_FORMS[name]]
    return [lambda x: (x,), lambda x: (x, x)]


def sweep(cluster):
    """In a mesh worker: each name of ``_sweep_names`` called on each
    sharded operand of ``SWEEP_OPERANDS`` (``_calls``: the first that
    runs), under the gather guard. Returns name -> (the call that ran, by
    operand; the gathers made, by operand), for every name that ran on an
    operand."""
    import warnings

    import nums_tpu_torch.numpy as nps
    from torch_parity import refusing_gathers

    app = mesh_app(cluster)
    out = {}
    for name in _sweep_names():
        fn = _function(nps, name)
        forms, gathered = {}, {}
        for tag, x, bs in SWEEP_OPERANDS:
            for k, call in enumerate(_calls(name)):
                record = []
                undo = refusing_gathers(record)
                try:
                    with np.errstate(all="ignore"), \
                            warnings.catch_warnings():
                        warnings.simplefilter("ignore")
                        fn(*call(app.array(x, block_shape=bs)))
                    forms[tag] = k
                except Exception:  # noqa: BLE001 - this call does not apply
                    pass
                finally:
                    undo()
                if record:
                    gathered.setdefault(tag, set()).update(record)
                if tag in forms:
                    break
        if forms:
            out[name] = (forms, {tag: sorted(g)
                                 for tag, g in gathered.items()})
    return out


# The names of the sweep whose call there is the form that C-M6..C-M9
# named (the others are held in that form by the table: cov and corrcoef
# of the columns, trapezoid along the rows, the method reshape), and the
# 1-D transforms and the shift, which copied a sharded vector whole
# before the mesh had a distributed FFT (tests/mesh_signal_tables.py).
SWEEP_FAULTS = {"sort", "argsort", "ravel", "concatenate", "delete",
                "vstack", "append", "flip", "flipud", "roll", "take",
                "tile", "tril", "triu", "diff", "gradient", "unwrap",
                "fft.fft", "fft.rfft", "array_split", "resize", "vander",
                "partition", "argpartition", "sort_complex", "ediff1d",
                "fft.ifft", "fft.irfft", "fft.hfft", "fft.ihfft",
                "fft.fftshift"}


def check_sweep(found, cluster):
    """Every name of the coverage report that ran on a sharded operand
    copied it whole to no process unless it is listed in
    ``LAYOUT_WHOLE`` or ``GATHERS_STILL`` (each with its reason, the
    meshes and the operands where it gathers) for that operand; every
    listed name that ran gathers on this mesh, on one of its operands,
    exactly where its entry says so (the lists only shrink); no name of
    ``SWEEP_FAULTS`` is listed for the matrices."""
    from torch_parity import GATHERS_STILL, LAYOUT_WHOLE, MATRIX

    listed = {**LAYOUT_WHOLE, **GATHERS_STILL}
    assert len(found) > 250, len(found)
    unlisted = sorted((name, tag) for name, (_, g) in found.items()
                      for tag in g
                      if name not in listed or tag not in listed[name][2])
    assert not unlisted, unlisted
    stale = [name for name in set(listed) & set(found)
             if bool(set(found[name][1]) & set(listed[name][2]))
             != (tuple(cluster) in listed[name][1])]
    assert not stale, sorted(stale)
    faults = [name for name in SWEEP_FAULTS
              if name in listed and set(MATRIX) & set(listed[name][2])]
    assert not faults, sorted(faults)


def check_layout_whole(found, jax_mesh):
    """Each sweep name in ``LAYOUT_WHOLE`` that ran on an operand of its
    entry gives, on the reference's (4, 1) mesh and in the same call, a
    result that its grid lays out whole (no axis of its PartitionSpec
    sharded): the reference holds it whole too."""
    import nums_tpu.numpy as jnps
    from torch_parity import LAYOUT_WHOLE

    for name in sorted(set(LAYOUT_WHOLE) & set(found)):
        fn = _function(jnps, name)
        forms, _ = found[name]
        for tag, x, bs in SWEEP_OPERANDS:
            if tag not in forms or tag not in LAYOUT_WHOLE[name][2]:
                continue
            res = fn(*_calls(name)[forms[tag]](jax_mesh.array(
                x, block_shape=bs)))
            for r in (res if isinstance(res, (tuple, list)) else [res]):
                if hasattr(r, "grid"):
                    spec = r.backend.spec_for_shape(r.shape,
                                                    r.grid.grid_shape)
                    assert all(ax is None for ax in spec), (name, tag,
                                                           r.grid, spec)
