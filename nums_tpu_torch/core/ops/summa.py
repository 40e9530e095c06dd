"""Hand-scheduled mesh GEMMs on torch.distributed: TN, NT, ring and SUMMA.

Counterpart of ``nums_tpu/core/ops/summa.py``, whose schedules are
``shard_map`` programs with ICI collectives. Here each schedule is the
same program written per process: its operands are first laid out as the
reference's ``in_specs`` say (``redistribute``), each process runs a local
product on its own shard, and the collectives of the mesh dimension's
process group (``DeviceMesh.get_group``) join the parts:

* ``tn``: C = Arawᵀ·B — a local product of the rows each process holds,
  then ONE ``reduce_scatter_tensor`` over m0 (the reference's
  ``psum_scatter``); for x.T @ x the local product is the gram kernel;
* ``nt``: C = A·Brawᵀ — ``all_gather_into_tensor`` of B's rows over m0,
  then a local ``A @ Bᵀ``;
* ``ring``: C = A·B — p − 1 hops of B's row shards around m0 by
  ``batch_isend_irecv``; the next shard's send and receive are posted
  before this step's product and waited on after it (the double buffer);
* ``summa``: C = A·B on a 2-D mesh — an all-gather of A over m1 and of B
  over m0, then a local product.

The collectives need equal parts: a ragged operand (DTensor's uneven
shards, ceil(m/p) rows on the first processes) is zero-padded into
scratch to ceil(m/p) rows for the schedule, and the result sliced back.
``choose_schedule`` and the ``*_supported`` predicates are the reference's
and read the reference's padded extents (``MeshBackend.physical_shape``),
so every shape dispatches to the reference's schedule. The local products
are plain torch calls (float32 with TF32 off) but for the gram kernel.

``gram_all_reduce`` is x.T @ x under the default route (collective matmul
off): the gram kernel on each process's rows and one all-reduce.
"""

import torch
import torch.distributed as dist

from nums_tpu_torch.core import multiprocess, trace
from nums_tpu_torch.core.grid import cdiv
from nums_tpu_torch.core.ops import cuda_gram, linear

# Auto-dispatch cost model (the reference's constants, summa.py:22-49).
AUTO_TN_MAX_PARTIAL_BYTES = 256 * 2**20
AUTO_NT_MAX_GATHER_BYTES = 256 * 2**20
AUTO_NN_GATHER_BUDGET_BYTES = 256 * 2**20
AUTO_RING_MIN_K_PANEL = 256

#: The schedule BlockArray._collective_matmul last dispatched: "tn" | "nt"
#: | "ring" | "summa" | "xla" (the default route) | None (never).
LAST_DISPATCH = None


def choose_schedule(mesh_backend, ta, tb, a_phys, b_phys, itemsize=4):
    """The reference's ``auto`` choice: "tn" | "nt" | "ring" | "summa" |
    None (the default route), from the transpose pattern and the PHYSICAL
    (the reference's padded) shapes of the untransposed raws."""
    if mesh_backend.mesh is None:
        return None
    if ta and tb:
        inner = choose_schedule(mesh_backend, False, False, b_phys, a_phys,
                                itemsize)
        return inner if inner in ("ring", "summa") else None
    if ta:
        if not tn_supported(mesh_backend, a_phys, b_phys):
            return None
        m, n = a_phys[1], b_phys[1]
        return "tn" if m * n * itemsize <= AUTO_TN_MAX_PARTIAL_BYTES else None
    if tb:
        if not nt_supported(mesh_backend, a_phys, b_phys):
            return None
        n, k = b_phys
        return "nt" if n * k * itemsize <= AUTO_NT_MAX_GATHER_BYTES else None
    k, n = b_phys
    if k * n * itemsize <= AUTO_NN_GATHER_BUDGET_BYTES:
        return None
    ms = mesh_backend.device_grid.mesh_shape
    if len(ms) > 1 and ms[1] > 1 and supported(mesh_backend, a_phys, b_phys):
        return "summa"
    if (ring_supported(mesh_backend, a_phys, b_phys)
            and a_phys[1] // ms[0] >= AUTO_RING_MIN_K_PANEL):
        return "ring"
    return None


def tn_supported(mesh_backend, a_raw_shape, b_raw_shape) -> bool:
    """Araw (K, m), B (K, n), both row-sharded; C (m, n) row-sharded."""
    if mesh_backend.mesh is None:
        return False
    if len(a_raw_shape) != 2 or len(b_raw_shape) != 2:
        return False
    p = mesh_backend.device_grid.mesh_shape[0]
    k, m = a_raw_shape
    k2, _ = b_raw_shape
    return k == k2 and p > 1 and k % p == 0 and m % p == 0


def nt_supported(mesh_backend, a_shape, b_raw_shape) -> bool:
    """A (m, K), Braw (n, K), row-sharded."""
    if mesh_backend.mesh is None:
        return False
    if len(a_shape) != 2 or len(b_raw_shape) != 2:
        return False
    p = mesh_backend.device_grid.mesh_shape[0]
    m, k = a_shape
    n, k2 = b_raw_shape
    return k == k2 and p > 1 and m % p == 0 and n % p == 0


def ring_supported(mesh_backend, a_shape, b_shape) -> bool:
    if mesh_backend.mesh is None:
        return False
    ms = mesh_backend.device_grid.mesh_shape
    if len(a_shape) != 2 or len(b_shape) != 2:
        return False
    p = ms[0]
    m, k = a_shape
    k2, _ = b_shape
    return k == k2 and p > 1 and m % p == 0 and k % p == 0


def supported(mesh_backend, a_shape, b_shape) -> bool:
    """SUMMA: a 2-D mesh whose axes divide m, k and n."""
    if mesh_backend.mesh is None:
        return False
    ms = mesh_backend.device_grid.mesh_shape
    if len(ms) < 2 or len(a_shape) != 2 or len(b_shape) != 2:
        return False
    p0, p1 = ms[:2]
    m, k = a_shape
    k2, n = b_shape
    return (k == k2 and m % p0 == 0 and k % p1 == 0 and k % p0 == 0
            and n % p1 == 0)


# ---------------------------------------------------------------------
# Layouts and padding
# ---------------------------------------------------------------------


def _spec(backend, *dims):
    """Placements: mesh dimension j shards array axis ``dims[j]`` (None or
    missing: replicated), as a shard_map in_spec."""
    from torch.distributed.tensor import Replicate, Shard

    n = len(backend.device_grid.mesh_shape)
    dims = tuple(dims) + (None,) * (n - len(dims))
    return tuple(Replicate() if d is None else Shard(d) for d in dims)


def local_part(t, placements):
    """The DTensor ``t``'s region under ``placements`` on this process."""
    if tuple(t.placements) != tuple(placements):
        t = multiprocess.sent_moved(t, t.redistribute(t.device_mesh,
                                                      placements))
    return t.to_local()


def row_layout(t):
    """``t``'s placements with its rows as they are and every other axis
    whole: each process then holds whole rows."""
    from torch.distributed.tensor import Replicate

    return tuple(p if p.is_shard() and p.dim == 0 else Replicate()
                 for p in t.placements)


def all_reduce_rows(mesh, rows, tensor, op=None):
    """Sum ``tensor`` (in place) over the processes that hold other rows:
    one all-reduce over each mesh dimension whose placement in ``rows``
    (``row_layout``'s) shards them. ``op`` (a ``dist.ReduceOp``; default
    SUM) combines them otherwise."""
    op = dist.ReduceOp.SUM if op is None else op
    with trace.span("nums.mesh.all_reduce"):
        for j, p in enumerate(rows):
            if p.is_shard() and mesh.size(j) > 1:
                dist.all_reduce(multiprocess.sent("all_reduce", tensor,
                                                  mesh.get_group(j)),
                                op=op, group=mesh.get_group(j))
    return tensor


def _pad_rows(x, rows):
    """``x`` with zero rows appended up to ``rows`` (scratch; ``x`` itself
    when it has them)."""
    if x.shape[0] == rows:
        return x.contiguous()
    out = x.new_zeros((rows,) + tuple(x.shape[1:]))
    out[:x.shape[0]] = x
    return out


def _common(a, b):
    """Both local operands in their promoted dtype."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _product(a, b):
    """A local product of two 2-D tensors in the operands' dtype (plain
    torch, TF32 off)."""
    return linear.tensordot(a, b, 1)


def _gram_local(x):
    """xᵀx of a process's rows in the ``tn`` schedule: the gram kernel
    where its gate is on."""
    if cuda_gram.enabled() and cuda_gram.supported(tuple(x.shape), x.dtype):
        return cuda_gram.gram(x.contiguous())
    return _product(x.T, x)


def gram_all_reduce(backend, raw):
    """x.T @ x of the row-sharded (n, d) DTensor ``raw`` under the default
    route, whose caller (``BlockArray._gram_fast``) has passed the gram
    kernel's gate: xᵀx of this process's rows through the kernel (zeros
    where an uneven shard left it none), then one all-reduce (SUM) over
    the mesh dimensions that shard the rows. Returns the whole (d, d)
    value, the same on every process: placing it by the grid is then a
    local slice."""
    rows = row_layout(raw)
    x = local_part(raw, rows)
    d = int(x.shape[1])
    part = (cuda_gram.gram(x.contiguous()) if x.shape[0]
            else x.new_zeros((d, d)))
    return all_reduce_rows(backend.mesh, rows, part)


# ---------------------------------------------------------------------
# The schedules: each takes DTensors and returns a DTensor
# ---------------------------------------------------------------------


def tn_matmul(backend, a_raw, b, same=False):
    """C = Arawᵀ·B: Araw (K, m) and B (K, n) row-sharded over m0; the
    (m, n) product of this process's rows (the gram kernel when ``same``:
    B is Araw), then one ``reduce_scatter_tensor`` over m0. C comes out
    row-sharded over m0."""
    spec = _spec(backend, 0)
    a_loc = local_part(a_raw, spec)
    partial = (_gram_local(a_loc) if same
               else _product(a_loc.T, local_part(b, spec)))
    m, n = partial.shape
    p = backend.device_grid.mesh_shape[0]
    c = cdiv(m, p)
    out = partial.new_empty((c, n))
    group = backend.mesh.get_group(0)
    dist.reduce_scatter_tensor(out, multiprocess.sent(
        "reduce_scatter", _pad_rows(partial, p * c), group), group=group)
    del partial
    box = backend.region((m, n), spec)
    local = out[:box[0][1] - box[0][0]]
    return backend.from_local(local, (m, n), spec)


def nt_matmul(backend, a, b_raw):
    """C = A·Brawᵀ: A (m, K) and Braw (n, K) row-sharded over m0; B's rows
    all-gathered over m0 (padded to ceil(n/p) a process), then this
    process's A rows times the gathered panel, transposed in the product.
    C comes out row-sharded over m0, as A."""
    spec = _spec(backend, 0)
    a_loc = local_part(a, spec)
    b_loc = local_part(b_raw, spec)
    n, k = b_raw.shape
    p = backend.device_grid.mesh_shape[0]
    c = cdiv(n, p)
    panel = b_loc.new_empty((p * c, k))
    group = backend.mesh.get_group(0)
    dist.all_gather_into_tensor(panel, multiprocess.sent(
        "all_gather", _pad_rows(b_loc, c), group), group=group)
    local = _product(a_loc, panel[:n].T)
    return backend.from_local(local, (a.shape[0], n), spec)


def _around_ring(backend, cur, step):
    """``step(j, shard)`` for each row shard j of a ring over m0: this
    process's own first, then each received from the previous ring
    position. The send of the current shard to the next position and the
    receive of the next are posted before the step and waited on after
    it (p − 1 hops, each counted in ``multiprocess.SENT``)."""
    p = backend.device_grid.mesh_shape[0]
    group = backend.mesh.get_group(0)
    ranks = dist.get_process_group_ranks(group)
    i = backend.mesh.get_local_rank(0)
    nxt, prv = ranks[(i + 1) % p], ranks[(i - 1) % p]
    for t in range(p):
        reqs = []
        if t < p - 1:
            buf = torch.empty_like(cur)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, multiprocess.sent("send", cur), nxt,
                           group),
                dist.P2POp(dist.irecv, buf, prv, group),
            ])
        step((i - t) % p, cur)
        for req in reqs:
            req.wait()
        if t < p - 1:
            cur = buf


def ring_matmul(backend, a, b):
    """C = A·B on a ring over m0: A (m, K) and B (K, n) row-sharded. At
    step t the process at ring position i holds B's shard (i − t) mod p and
    adds the product of the matching K columns of its A rows
    (``_around_ring``)."""
    spec = _spec(backend, 0)
    a_loc, b_loc = _common(local_part(a, spec), local_part(b, spec))
    k, n = b.shape
    kc = cdiv(k, backend.device_grid.mesh_shape[0])
    acc = a_loc.new_zeros((a_loc.shape[0], n))

    def step(j, cur):
        lo, hi = min(j * kc, k), min((j + 1) * kc, k)
        if hi > lo:
            acc.addmm_(a_loc[:, lo:hi], cur[:hi - lo])

    _around_ring(backend, _pad_rows(b_loc, kc), step)
    return backend.from_local(acc, (a.shape[0], n), spec)


def ring_nt(backend, a, b, conj=False):
    """C = A·Bᵀ (A·Bᴴ with ``conj``) on a ring over m0: A (m, K) and
    B (n, K), each by rows over m0 with every column. At step t the
    process at ring position i holds B's row shard (i − t) mod p and fills
    the matching columns of its rows of C (``_around_ring``). No process
    holds more of B than two shards, and C comes out row-sharded over m0,
    as A: never built from an all-gather (``nt_matmul`` gathers B's
    rows)."""
    spec = _spec(backend, 0)
    a_loc, b_loc = _common(local_part(a, spec), local_part(b, spec))
    n = int(b.shape[0])
    nc = cdiv(n, backend.device_grid.mesh_shape[0])
    acc = a_loc.new_empty((a_loc.shape[0], n))

    def step(j, cur):
        lo, hi = min(j * nc, n), min((j + 1) * nc, n)
        if hi > lo:
            block = cur[:hi - lo]
            acc[:, lo:hi] = _product(a_loc, (block.conj() if conj
                                             else block).T)

    _around_ring(backend, _pad_rows(b_loc, nc), step)
    return backend.from_local(acc, (int(a.shape[0]), n), spec)


def summa_matmul(backend, a, b):
    """C = A·B on a 2-D mesh (p0, p1): A (m, K) and B (K, n) sharded
    (m0, m1). A's column shards are all-gathered over m1 (its row panel,
    ceil(K/p1) columns a part) and B's row shards over m0 (its column
    panel); the local product sums the panel's parts against the matching
    rows of B's panel. C comes out sharded (m0, m1)."""
    spec = _spec(backend, 0, 1)
    a_loc, b_loc = _common(local_part(a, spec), local_part(b, spec))
    m, k = a.shape
    n = b.shape[1]
    p0, p1 = backend.device_grid.mesh_shape[:2]
    kc1, kc0 = cdiv(k, p1), cdiv(k, p0)
    if a_loc.shape[1] == kc1:
        a_pad = a_loc.contiguous()
    else:
        a_pad = a_loc.new_zeros((a_loc.shape[0], kc1))
        a_pad[:, :a_loc.shape[1]] = a_loc
    parts = a_loc.new_empty((p1 * a_loc.shape[0], kc1))
    g1 = backend.mesh.get_group(1)
    dist.all_gather_into_tensor(parts, multiprocess.sent("all_gather", a_pad,
                                                         g1), group=g1)
    del a_pad
    parts = parts.view(p1, a_loc.shape[0], kc1)
    panel = b_loc.new_empty((p0 * kc0, b_loc.shape[1]))
    g0 = backend.mesh.get_group(0)
    dist.all_gather_into_tensor(panel, multiprocess.sent(
        "all_gather", _pad_rows(b_loc, kc0), g0), group=g0)
    acc = a_loc.new_zeros((a_loc.shape[0], b_loc.shape[1]))
    for j in range(p1):
        lo, hi = min(j * kc1, k), min((j + 1) * kc1, k)
        if hi > lo:
            acc.addmm_(parts[j][:, :hi - lo], panel[lo:hi])
    return backend.from_local(acc, (m, n), spec)


SCHEDULES = {"tn": tn_matmul, "nt": nt_matmul, "ring": ring_matmul,
             "summa": summa_matmul}
