"""Shared pieces of the port's parity tests (tests/test_torch_*.py).

The same numpy inputs go through nums_tpu (JAX on the CPU, x64 on as
tests/conftest.py sets it) and nums_tpu_torch (torch on the CPU, where
every kernel wrapper takes its plain version), and the outputs are
compared with a tolerance stated in each test file.
"""

import numpy as np
import pytest
import torch

# The suite runs several pytest workers on few cores: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

# bf16 MACs with f32 accumulation: the reference kernels' own oracle
# tolerances (tests/core/ops/test_pallas_gram.py:11 and
# tests/core/ops/test_pallas_newton.py:11).
GRAM_BF16_REL = 2e-3
STATS_BF16_REL = 4e-3


def rel_err(got, ref):
    """max|got - ref| / max|ref| in float64."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30))


@pytest.fixture(scope="module")
def jax_app():
    """nums_tpu's serial application (no lane padding)."""
    from nums_tpu.core import application_manager, settings

    old = settings.backend_name
    settings.backend_name = "serial"
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    settings.backend_name = old
    application_manager.destroy()


@pytest.fixture()
def padded_jax_app(monkeypatch):
    """nums_tpu with at-rest lane padding and the Pallas gram forced on
    (interpret mode on the CPU): its kernel route."""
    from nums_tpu.core import application_manager, settings as jsettings

    monkeypatch.setattr(jsettings, "lane_pad", True)
    monkeypatch.setattr(jsettings, "lane_pad_min", 8)
    monkeypatch.setattr(jsettings, "backend_name", "serial")
    monkeypatch.setenv("NUMS_TPU_PALLAS_GRAM", "1")
    application_manager.destroy()
    app = application_manager.create()
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()
    # The reference's jitted fit is cached by shape: drop it, so that a
    # later test that spies on the trace (test_lane_pad.py) retraces.
    import jax

    jax.clear_caches()


@pytest.fixture(scope="module")
def torch_app():
    """nums_tpu_torch's application on the CPU."""
    from nums_tpu_torch.core import application_manager

    application_manager.destroy()
    app = application_manager.create(device="cpu")
    application_manager.set_instance(app)
    yield app
    application_manager.destroy()


@pytest.fixture()
def spy_calls(monkeypatch):
    """Record the calls of module functions: ``spy(module, "name")``
    returns the list that each call of ``module.name`` appends its
    arguments to."""

    def spy(module, name):
        calls = []
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            calls.append(args)
            return orig(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
        return calls

    return spy


# The classes of tests/test_torch_random.py (its docstring states them).


def draw_mismatch(got, ref, rtol, atol):
    """Fraction of elements outside rtol*|ref| + atol*max|ref|."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    ok = np.abs(got - ref) <= rtol * np.abs(ref) + atol * scale
    ok |= (got == ref) | (np.isnan(got) & np.isnan(ref))
    return 1.0 - float(np.mean(ok))


def assert_draw_class(cls, got, ref, dtype_name):
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.dtype, ref.dtype)
    if cls == "exact":
        assert np.array_equal(got, ref)
    elif cls == "ulp":
        rtol, atol = {"float64": (1e-12, 1e-12),
                      "float32": (2e-6, 1e-6)}[dtype_name]
        assert draw_mismatch(got, ref, rtol, atol) == 0.0
    elif cls == "angle":
        # the sampler's own variable: the cosine of the angle from mu
        mu = 0.5
        assert draw_mismatch(np.cos(got - mu), np.cos(ref - mu), 1e-5,
                             1e-5) <= 1e-3
        assert draw_mismatch(got, ref, 0.0, 1e-3 / np.pi) <= 1e-3
    elif cls == "negative_binomial":
        # law only: mean n(1-p)/p and variance n(1-p)/p^2 for (5, 0.4)
        assert (got >= 0).all() and (got == np.round(got)).all()
        assert abs(got.mean() - 7.5) < 6 * np.sqrt(18.75 / got.size)
        assert abs(got.var() - 18.75) < 3.0
    else:
        assert cls == "looped"
        assert draw_mismatch(got, ref, 1e-5, 1e-5) <= 1e-3


# The classes of the facade's parity tests (tests/test_torch_numpy_*.py,
# tests/test_torch_access.py): (rtol, atol as a fraction of max|ref|) by
# the reference's dtype; integer, bool, sort, index, set and shape results
# are exact in every class.
TOLERANCES = {
    "elementwise": {"float64": (1e-12, 1e-12), "float32": (2e-6, 1e-6)},
    "reduction": {"float64": (0.0, 1e-12), "float32": (0.0, 1e-5)},
    "linalg": {"float64": (0.0, 1e-10), "float32": (0.0, 1e-4)},
    "poly": {"float64": (0.0, 1e-8), "float32": (0.0, 1e-4)},
}


def host(x):
    """A result of either package as numpy (nested for tuples/lists)."""
    if isinstance(x, (tuple, list)):
        return type(x)(host(v) for v in x) if not hasattr(x, "_fields") \
            else tuple(host(v) for v in x)
    if hasattr(x, "get") and hasattr(x, "grid"):
        return np.asarray(x.get())
    return x


def run_parity(fn):
    """``fn()`` as (result on the host, None) or (None, exception type)."""
    try:
        with np.errstate(all="ignore"):
            return host(fn()), None
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return None, type(e)


def _complex_parts(x):
    return (x.real, x.imag) if np.iscomplexobj(x) else (x,)


def assert_values(got, ref, tol="elementwise"):
    """Shape, dtype and value of one result against the reference's."""
    if isinstance(ref, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(ref), (
            got, ref)
        for g, r in zip(got, ref):
            assert_values(g, r, tol)
        return
    if not isinstance(ref, np.ndarray) and not isinstance(ref, np.generic):
        assert got == ref, (got, ref)
        return
    got = np.asarray(got)
    assert got.shape == ref.shape and got.dtype == ref.dtype, (
        got.shape, got.dtype, ref.shape, ref.dtype)
    if ref.dtype.kind in "biuUSO" or tol == "exact":
        assert np.array_equal(got, ref, equal_nan=ref.dtype.kind in "fc"), (
            got, ref)
        return
    name = "float32" if ref.dtype in (np.float32, np.complex64) else "float64"
    rtol, atol = TOLERANCES[tol][name]
    for g, r in zip(_complex_parts(got), _complex_parts(ref)):
        g, r = g.astype(np.float64), r.astype(np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(r)), (g, r)
        inf = np.isinf(r)
        assert np.array_equal(g[inf], r[inf]), (g, r)
        fin = np.isfinite(r)
        if fin.any():
            scale = np.max(np.abs(r[fin]))
            err = np.abs(g[fin] - r[fin])
            assert np.all(err <= rtol * np.abs(r[fin]) + atol * scale), (
                float(err.max()), scale, g, r)


def assert_parity(got, ref, tol="elementwise"):
    """Two ``run_parity`` outcomes agree: the same exception type, or the
    same values (``assert_values``)."""
    (g, g_exc), (r, r_exc) = got, ref
    if r_exc is not None:
        assert g_exc is r_exc, (g_exc, r_exc)
        return
    assert g_exc is None, g_exc
    assert_values(g, r, tol)


@pytest.fixture()
def apps(jax_app, torch_app):
    """Both serial applications, each its package's current instance for
    the test (a test with ``padded_jax_app`` replaces the reference's)."""
    from nums_tpu.core import application_manager as jam
    from nums_tpu_torch.core import application_manager as tam

    jam.set_instance(jax_app)
    tam.set_instance(torch_app)
    return jax_app, torch_app


def facade_parity(apps, fn, tol="elementwise"):
    """``fn(nps, app)`` through ``nums_tpu.numpy`` and
    ``nums_tpu_torch.numpy``, compared by ``assert_parity``."""
    import nums_tpu.numpy as jnps
    import nums_tpu_torch.numpy as tnps

    jax_app, torch_app = apps
    assert_parity(run_parity(lambda: fn(tnps, torch_app)),
                  run_parity(lambda: fn(jnps, jax_app)), tol)


# ---------------------------------------------------------------------
# A pool of 4 gloo processes for the mesh tests (tests/test_torch_mesh*.py,
# test_torch_summa.py, test_torch_multiprocess.py)
# ---------------------------------------------------------------------

MESH_WORLD = 4
# Every wait on the workers has a deadline: on expiry they are killed and
# the case fails, so no collective left waiting can hang the suite. The
# deadline counts the time in which the workers make no progress (use
# less than MESH_IDLE_CPU_SECONDS of CPU time between them in a
# MESH_POLL_SECONDS poll): a collective left waiting uses none, while a
# case slowed by a loaded host (the workers' start and imports, a mesh's
# process groups) goes on, up to MESH_CASE_CAP_SECONDS in all.
MESH_CASE_SECONDS = 60.0
MESH_CASE_CAP_SECONDS = 600.0
MESH_POLL_SECONDS = 5.0
MESH_IDLE_CPU_SECONDS = 0.5
_BLOCKED = ("jax", "jaxlib", "nums_tpu", "optax")


class _Block:
    """A meta-path finder that refuses the reference's packages: the
    workers run the port alone."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in _BLOCKED:
            raise ImportError("blocked in a mesh worker: " + name)
        return None


def _mesh_worker(rank, world, init_file, inbox, outbox):
    import os
    import sys
    import traceback

    sys.meta_path.insert(0, _Block())
    os.environ.update({
        "NUMS_TPU_TORCH_INIT_FILE": init_file,
        "NUMS_TPU_TORCH_NUM_PROCESSES": str(world),
        "NUMS_TPU_TORCH_PROCESS_ID": str(rank),
        "CUDA_VISIBLE_DEVICES": "",
    })
    import torch as _torch

    _torch.set_num_threads(1)
    from nums_tpu_torch.core import multiprocess

    multiprocess.initialize("cpu")
    while True:
        item = inbox.get()
        if item is None:
            break
        fn, args, kwargs = item
        try:
            outbox.put((rank, True, fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 - sent back to the test
            outbox.put((rank, False, traceback.format_exc()))
    import torch.distributed as dist

    dist.destroy_process_group()


class MeshPool:
    """``MESH_WORLD`` worker processes (``spawn``), joined once into a gloo
    group through a ``file://`` rendezvous under ``root`` (no port). ``run``
    calls a top-level function on every rank and returns rank 0's result;
    a rank that raised fails the call with its traceback. Workers never
    import jax, jaxlib, optax or nums_tpu (their imports are blocked), so
    a case function's module keeps those imports inside its tests."""

    def __init__(self, root, world=MESH_WORLD):
        self.root, self.world, self._generation = root, world, 0
        self._procs = []

    def _start(self):
        import multiprocessing as mp
        import os

        self._generation += 1
        init_file = os.path.join(str(self.root),
                                 f"rendezvous{self._generation}")
        ctx = mp.get_context("spawn")
        self._outbox = ctx.Queue()
        self._inboxes = [ctx.Queue() for _ in range(self.world)]
        self._procs = [
            ctx.Process(target=_mesh_worker, daemon=True, args=(
                r, self.world, init_file, self._inboxes[r], self._outbox))
            for r in range(self.world)
        ]
        for p in self._procs:
            p.start()

    def kill(self):
        for p in self._procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        self._procs = []

    def _cpu_seconds(self):
        """The CPU time that the workers have used (Linux's /proc)."""
        import os

        total = 0
        for p in self._procs:
            try:
                with open(f"/proc/{p.pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            total += int(fields[11]) + int(fields[12])
        return total / os.sysconf("SC_CLK_TCK")

    def run(self, fn, *args, timeout=MESH_CASE_SECONDS, **kwargs):
        """``timeout``: the seconds the workers may go without progress
        (see MESH_CASE_SECONDS)."""
        import queue
        import time

        if not self._procs or not all(p.is_alive() for p in self._procs):
            self.kill()
            self._start()
        for box in self._inboxes:
            box.put((fn, args, kwargs))
        start = last = time.monotonic()
        cpu = self._cpu_seconds()
        results = {}
        while len(results) < self.world:
            try:
                rank, ok, value = self._outbox.get(
                    timeout=min(MESH_POLL_SECONDS, timeout))
            except queue.Empty:
                now, used = time.monotonic(), self._cpu_seconds()
                if used - cpu >= MESH_IDLE_CPU_SECONDS:
                    last = now
                cpu = used
                if (now - last < timeout and now - start
                        < max(timeout, MESH_CASE_CAP_SECONDS)):
                    continue
                self.kill()
                said = "\n".join(f"rank {r}: {v}" for r, (ok, v)
                                 in sorted(results.items()) if not ok)
                raise AssertionError(
                    f"{fn.__name__}: {self.world - len(results)} rank(s) "
                    f"did not answer: no progress for {now - last:.0f} s "
                    f"(deadline {timeout} s), {now - start:.0f} s in all; "
                    "workers killed\n" + said)
            results[rank] = (ok, value)
        failed = {r: v for r, (ok, v) in results.items() if not ok}
        if failed:
            raise AssertionError(f"{fn.__name__} failed on ranks "
                                 f"{sorted(failed)}:\n" + "\n".join(
                                     failed.values()))
        return results[0][1]

    def close(self):
        for box in getattr(self, "_inboxes", []):
            box.put(None)
        for p in self._procs:
            p.join(10)
        self.kill()


@pytest.fixture(scope="module")
def mesh_pool(tmp_path_factory):
    pool = MeshPool(tmp_path_factory.mktemp("mesh"))
    yield pool
    pool.close()


_MESH_APPS = {}


def mesh_app(cluster_shape=(4, 1)):
    """In a mesh worker: the port's mesh application on the CPU over the
    pool's group (one per cluster shape, kept for the worker's life: a
    DeviceMesh makes process groups), made current."""
    from nums_tpu_torch.core import application_manager

    cluster_shape = tuple(cluster_shape)
    if cluster_shape not in _MESH_APPS:
        _MESH_APPS[cluster_shape] = application_manager.create(
            device="cpu", backend="mesh", cluster_shape=cluster_shape)
    app = _MESH_APPS[cluster_shape]
    application_manager.set_instance(app)
    return app


@pytest.fixture()
def jax_mesh():
    """nums_tpu's mesh application on a (4, 1) mesh of the 8 virtual CPU
    devices, made current; the application before it is restored after."""
    from nums_tpu.core import application_manager
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.io.filesystem import FileSystem

    backend = MeshBackend(cluster_shape=(4, 1)).init()
    app = ArrayApplication(backend, FileSystem(backend))
    old = application_manager._instance
    application_manager.set_instance(app)
    yield app
    application_manager.set_instance(old)


# ---------------------------------------------------------------------
# The gather guard: no op of the port's mesh copies a sharded operand
# whole to a process, but where it is listed below
# ---------------------------------------------------------------------

# Above this many elements a replicated copy of a sharded DTensor is a
# gather of an operand; below it, a small result laid out whole by its
# grid (counts, edges, a handful of distinct values).
WHOLE_LIMIT = 1000


def refusing_gathers(record=None):
    """Patch DTensor so that a whole copy of a sharded operand raises
    ``AssertionError`` (with a list ``record``: is appended to it, and
    goes on): ``DTensor.full_tensor`` and every redistribution of a
    sharded DTensor of more than ``WHOLE_LIMIT`` elements to Replicate on
    every mesh dimension (DTensor's own, inside an operator too, or
    ``MeshBackend.rebox``). Returns the undo."""
    import torch.distributed.tensor._api as api
    import torch.distributed.tensor._dispatch as dispatch
    import torch.distributed.tensor._redistribute as redist
    from torch.distributed.tensor import DTensor

    from nums_tpu_torch.core.backend import MeshBackend

    orig = redist.redistribute_local_tensor
    orig_full = DTensor.full_tensor
    orig_rebox = MeshBackend.rebox

    def gathers(current, target, shape):
        return (any(p.is_shard() for p in current)
                and all(not p.is_shard() for p in target)
                and int(np.prod(shape)) > WHOLE_LIMIT)

    def refuse(what):
        if record is None:
            raise AssertionError(what)
        record.append(what)

    def redistribute_local_tensor(local, current, target, *args, **kwargs):
        if gathers(current.placements, target.placements, target.shape):
            refuse(f"gathered a sharded {tuple(target.shape)}")
        return orig(local, current, target, *args, **kwargs)

    def full_tensor(self, *args, **kwargs):
        if self.numel() > WHOLE_LIMIT:
            refuse(f"full_tensor of {tuple(self.shape)}")
        return orig_full(self, *args, **kwargs)

    def rebox(self, data, placements):
        if gathers(data.placements, placements, data.shape):
            refuse(f"reboxed a sharded {tuple(data.shape)} whole")
        return orig_rebox(self, data, placements)

    mods = (api, dispatch, redist)
    for m in mods:
        m.redistribute_local_tensor = redistribute_local_tensor
    DTensor.full_tensor = full_tensor
    MeshBackend.rebox = rebox

    def undo():
        for m in mods:
            m.redistribute_local_tensor = orig
        DTensor.full_tensor = orig_full
        MeshBackend.rebox = orig_rebox

    return undo


# The names (a facade name of the sweep of tests/mesh_shape_tables.py, or
# a table's entry) that may still copy a sharded operand whole: name ->
# (reason, the meshes where it does, the sweep's operands on which it
# does: ``MATRIX``, the sharded 1000×8 and 1003×7; ``VECTOR``, the
# sharded 1003-vector). ``LAYOUT_WHOLE``: the result's grid is one block
# by the reference's layout (``_wrap``'s rule: a result of another rank
# than its operand, or of ``block``, is one block), so the
# reference's mesh holds it whole too (tests/test_torch_mesh_shape.py
# checks that grid on nums_tpu's mesh).
BOTH = ((4, 1), (2, 2))
MATRIX = ("even", "uneven")
VECTOR = ("vector",)
EVERY = MATRIX + VECTOR
_ONE_BLOCK = ("a result of another rank than its operand is one block "
              "(_wrap's rule, the reference's too)")
LAYOUT_WHOLE = {
    "block": ("jnp.block's result is one block (from_torch, from_jax in "
              "the reference)", BOTH, EVERY),
    "dstack": (_ONE_BLOCK + ": (n, d, 2) of (n, d), (1, n, 2) of (n,)",
               BOTH, EVERY),
    "stack": (_ONE_BLOCK + ": (2, n, d) of (n, d), (2, n) of (n,)", BOTH,
              EVERY),
    "expand_dims": (_ONE_BLOCK + ": (1, n, d) of (n, d), (1, n) of (n,)",
                    BOTH, EVERY),
    "insert": (_ONE_BLOCK + ": axis=None, (n·d + 1,) of (n, d)", BOTH,
               MATRIX),
    "meshgrid": (_ONE_BLOCK + ": (n·d,) of (n, d)", BOTH, MATRIX),
    "vecdot": (_ONE_BLOCK + ": (n,) of (n, d)", BOTH, MATRIX),
    "linalg.vecdot": (_ONE_BLOCK + ": (n,) of (n, d)", BOTH, MATRIX),
    "trapezoid": (_ONE_BLOCK + ": along the last axis, (n,) of (n, d); "
                  "along the rows it is sharded (CM7_trapezoid_*)", BOTH,
                  MATRIX),
    "trapz": (_ONE_BLOCK + ": as trapezoid", BOTH, MATRIX),
    "rot90": ("(d, n) in (d, d) blocks: axis 0 one block, axis 1 on a "
              "mesh dimension of one process (on (2, 2) it is sharded)",
              ((4, 1),), MATRIX),
    "reshape": ("nps.reshape takes the reference's block policy "
                "(compute_block_shape: one block under 100 MB); the method "
                "keeps the rows sharded (CM7_reshape_*)", BOTH, EVERY),
    "atleast_2d": (_ONE_BLOCK + ": (1, n) of (n,)", BOTH, VECTOR),
    "atleast_3d": (_ONE_BLOCK + ": (1, n, 1) of (n,)", BOTH, VECTOR),
    "bmat": (_ONE_BLOCK + ": (1, n) of (n,)", BOTH, VECTOR),
    "column_stack": (_ONE_BLOCK + ": (n, 2) of two (n,)", BOTH, VECTOR),
    "row_stack": (_ONE_BLOCK + ": (2, n) of two (n,)", BOTH, VECTOR),
    "vstack": (_ONE_BLOCK + ": (2, n) of two (n,); of matrices it is "
               "sharded (CM7_vstack_*)", BOTH, VECTOR),
    "tile": (_ONE_BLOCK + ": tile(v, (2, 1)) is (2, n) of (n,); of "
             "matrices it is sharded (CM7_tile_*)", BOTH, VECTOR),
}
# ``GATHERS_STILL``: what reads a sharded operand whole by design; this
# list only shrinks.
_HOST = "reads the values to the host by design (the reference's too)"
GATHERS_STILL = {
    "array2string": (_HOST + ": printing", BOTH, EVERY),
    "array_repr": (_HOST + ": printing", BOTH, EVERY),
    "array_str": (_HOST + ": printing", BOTH, EVERY),
    "min_scalar_type": (_HOST + ": np.min_scalar_type of the values",
                        BOTH, EVERY),
    "asmatrix": (_HOST + ": a HOST_FALLBACK name", BOTH, EVERY),
    "poly": (_HOST + ": np.poly of a matrix (its eigenvalues; the sweep's "
             "non-square ones then refused)", BOTH, MATRIX),
}


def assert_gathers_allowed(name, gathered):
    """``gathered`` (a ``refusing_gathers`` record) is empty unless
    ``name`` is in ``LAYOUT_WHOLE`` or ``GATHERS_STILL``."""
    if name in LAYOUT_WHOLE or name in GATHERS_STILL:
        return
    assert not gathered, (name, gathered)


# ---------------------------------------------------------------------
# Tables of ops run through every package (tests/test_torch_mesh_index.py,
# tests/test_torch_mesh_setops.py)
# ---------------------------------------------------------------------


def _placed_like_array(app, result):
    """Whether each process holds of a BlockArray result what
    ``app.array`` of its value, shape and blocks puts there (collective)."""
    if result.backend.mesh is None or result.is_transposed:
        return True
    ref = app.array(np.asarray(result.get()), block_shape=result.block_shape)
    if tuple(ref.raw.placements) != tuple(result.raw.placements):
        return False
    a, b = result.raw.to_local().numpy(), ref.raw.to_local().numpy()
    return a.shape == b.shape and np.array_equal(
        a, b, equal_nan=a.dtype.kind in "fc")


def _results(x):
    if isinstance(x, (tuple, list)):
        return [r for v in x for r in _results(v)]
    return [x] if hasattr(x, "get") and hasattr(x, "grid") else []


def run_table(app, nps, table, placed=False):
    """name -> (value on the host, exception type name) for each
    ``(name, fn)`` of ``table``, ``fn(app, nps)`` run in order; with
    ``placed`` (on the mesh, collective), also name -> (whether every
    BlockArray result lies as ``app.array`` would place it, on every
    process; the whole copies of sharded operands that the entry made,
    ``refusing_gathers``' record, while it ran and not while its result
    was read)."""
    values, where = {}, {}
    for name, fn in table:
        record = []
        undo = refusing_gathers(record) if placed else (lambda: None)
        try:
            with np.errstate(all="ignore"):
                out = fn(app, nps)
            undo()
            values[name] = (host(out), None)
            if placed:
                # every check runs on every rank: each is collective
                where[name] = (all([_placed_like_array(app, r)
                                    for r in _results(out)]), record)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            undo()
            values[name] = (None, type(e).__name__)
            where[name] = (True, record)
    if placed:
        import torch.distributed as dist

        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, where)
        where = {k: (all(w[k][0] for w in every),
                     sorted({g for w in every for g in w[k][1]}))
                 for k in where}
    return values, where


def jax_mesh_values(cluster, table):
    """``run_table`` through nums_tpu's mesh of ``cluster`` over the 8
    virtual CPU devices; the application before it is restored after."""
    import nums_tpu.numpy as jnps
    from nums_tpu.core import application_manager
    from nums_tpu.core.array.application import ArrayApplication
    from nums_tpu.core.backend import MeshBackend
    from nums_tpu.core.io.filesystem import FileSystem

    backend = MeshBackend(cluster_shape=tuple(cluster)).init()
    app = ArrayApplication(backend, FileSystem(backend))
    old = application_manager._instance
    application_manager.set_instance(app)
    try:
        return run_table(app, jnps, table)[0]
    finally:
        application_manager.set_instance(old)


def assert_table_entry(got, ref, tol="elementwise"):
    """One entry of two ``run_table``s: the same exception type, or equal
    values (``assert_values``)."""
    (g, g_exc), (r, r_exc) = got, ref
    if r_exc is not None:
        assert g_exc == r_exc, (g_exc, r_exc)
        return
    assert g_exc is None, g_exc
    assert_values(g, r, tol)
