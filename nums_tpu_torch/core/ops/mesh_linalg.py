"""Distributed factorizations of a sharded square matrix: Cholesky, the
Cholesky solve and the inverse, on the mesh backend.

Counterpart of what the reference's mesh leaves to XLA's solver calls on a
sharded operand (``nums_tpu/core/ops/linalg.py``: ``cholesky``,
``posdef_solve``, ``inv``). DTensor has no sharding strategy for them, and
the operand is never gathered: it is first laid out by rows (each mesh
dimension that shards either axis shards the rows; an all-to-all of the
same per-process size, ``MeshBackend.rebox``), and the processes of a row
group (``_Rows``) work on their own rows, joined by collectives of a panel
at a time. The panel ops are ``torch.linalg`` and ``torch.matmul``
(cuSOLVER and cuBLAS on the card): there is no hand-written kernel here, as
the reference has none.

* ``cholesky``: a blocked right-looking Cholesky over row panels (each
  within one process's rows, at most ``b`` wide): the owner factors the
  diagonal block, the block goes to every process, each solves its own
  rows of the panel, the panel column (n × b, never the whole matrix) is
  all-gathered, and each process updates its own rows of the trailing
  matrix.
* ``posdef_solve``: ``cholesky``, then the forward and backward
  substitutions on the row-sharded factor, one panel at a time (one
  broadcast a panel forward, one all-reduce and one broadcast back).
* ``inv``: a blocked Gauss-Jordan with partial pivoting on [A | I]: each
  panel column is all-gathered and every process chooses the same pivots
  in it, by partial pivoting's LU of its rows not yet used (the largest
  |value|, the first on ties);
  the pivot rows (b × 2n) are all-gathered and every process eliminates
  the panel from its own rows. The rows are never swapped in place: the
  pivot order is known everywhere, and the rows of A⁻¹ move to their
  places by one ``mesh_ops.pull`` at the end. Pivoting only decides which
  rows lead; the values agree with a serial inverse to rounding.

The panel width ``b`` is the operand's row block, at least ``MIN_PANEL`` on
the card (a narrower panel leaves the card idle between collectives).

* ``householder_qr``: the reduced QR of a tall sharded matrix by the
  Householder tree (``linalg._direct_tsqr_impl``) on each process's rows,
  then the row holders' R factors stacked in row order (one all-gather
  of n×n a process) and factored once more; each process's rows of Q are
  its own Q times its block of the stack's Q. X is never gathered.
"""

import torch

from nums_tpu_torch.core import multiprocess
from nums_tpu_torch.core.ops import linalg, mesh_ops

# The least panel width on a CUDA device.
MIN_PANEL = 64


class _Rows:
    """The row layout of a square DTensor and its row group: the
    processes that hold its rows between them (those that agree on every
    mesh dimension that does not shard the rows), each one's row range,
    and the process group of their collectives (None: the whole world)."""

    def __init__(self, backend, data):
        import torch.distributed as dist

        self.backend = backend
        self.shape = tuple(int(s) for s in data.shape)
        self.placements = tuple(mesh_ops._shard(0) if p.is_shard()
                                else mesh_ops._replicate()
                                for p in data.placements)
        self.data = backend.rebox(data, self.placements)
        mesh_shape = backend.device_grid.mesh_shape
        dims = [k for k, p in enumerate(self.placements)
                if p.is_shard() and mesh_shape[k] > 1]
        busy = [k for k in range(len(mesh_shape)) if mesh_shape[k] > 1]
        self.multi = bool(dims) and multiprocess.is_multiprocess()
        if not self.multi:
            self.group = None
        elif dims == busy:
            self.group = dist.group.WORLD
        else:
            assert len(dims) == 1, dims
            self.group = backend.mesh.get_group(dims[0])
        members, _ = backend._row_groups(self.placements)
        coords = backend.coords()
        self.members = members
        self.ranges = {r: backend.region(self.shape, self.placements,
                                         coords[r])[0] for r in members}
        self.me = multiprocess.process_index()
        self.r0, self.r1 = self.ranges[self.me]

    def panels(self, width):
        """(start, stop, owner) of each row panel, in order: the rows of
        each process cut into pieces of at most ``width``."""
        out = []
        for r in sorted(self.members, key=lambda r: self.ranges[r][0]):
            a, b = self.ranges[r]
            for s in range(a, b, width):
                out.append((s, min(s + width, b), r))
        return out

    def broadcast(self, tensor, owner):
        """``tensor`` from ``owner`` to the row group (in place: it must be
        contiguous, as LAPACK's column-major factors are not)."""
        import torch.distributed as dist

        assert tensor.is_contiguous()
        if self.multi:
            dist.broadcast(multiprocess.sent("broadcast", tensor, self.group),
                           src=owner, group=self.group)
        return tensor

    def all_reduce(self, tensor):
        import torch.distributed as dist

        if self.multi:
            dist.all_reduce(multiprocess.sent("all_reduce", tensor,
                                              self.group), group=self.group)
        return tensor

    def gather_rows(self, local, lo):
        """The rows ``[lo, n)`` of a row-sharded (n, w) matrix whose rows
        ``[max(lo, r0), r1)`` this process holds in ``local``: one
        all-gather over the row group (padded to the longest part)."""
        import torch.distributed as dist

        if not self.multi:
            return local
        parts = {r: (max(a, lo), max(b, lo)) for r, (a, b)
                 in self.ranges.items()}
        top = max(b - a for a, b in parts.values())
        buf = local.new_zeros((top,) + tuple(local.shape[1:]))
        buf[:local.shape[0]] = local
        got = [torch.empty_like(buf) for _ in range(
            dist.get_world_size(self.group))]
        dist.all_gather(got, multiprocess.sent("all_gather", buf, self.group),
                        group=self.group)
        by_rank = {dist.get_global_rank(self.group, i) if self.group
                   is not dist.group.WORLD else i: g
                   for i, g in enumerate(got)}
        order = sorted(self.members, key=lambda r: parts[r][0])
        return torch.cat([by_rank[r][:parts[r][1] - parts[r][0]]
                          for r in order])


def panel_width(block_rows, device):
    width = max(1, int(block_rows))
    if torch.device(device).type == "cuda":
        width = max(width, MIN_PANEL)
    return width


def _cholesky_rows(rows, width):
    """The lower Cholesky factor's rows on this process (the row layout of
    ``rows``), by the blocked right-looking algorithm."""
    n = rows.shape[0]
    a = rows.data.to_local().clone(memory_format=torch.contiguous_format)
    r0, r1 = rows.r0, rows.r1
    for k0, k1, owner in rows.panels(width):
        b = k1 - k0
        if rows.me == owner:
            lkk = linalg.cholesky(a[k0 - r0:k1 - r0, k0:k1]).contiguous()
            a[k0 - r0:k1 - r0, k0:k1] = lkk
        else:
            lkk = a.new_empty((b, b))
        rows.broadcast(lkk, owner)
        # this process's rows below the panel: their part of the panel
        lo = max(k1, r0)
        if r1 > lo:
            a[lo - r0:, k0:k1] = torch.linalg.solve_triangular(
                lkk.T, a[lo - r0:, k0:k1], upper=True, left=False)
        if k1 >= n:
            continue
        strip = rows.gather_rows(a[lo - r0:, k0:k1] if r1 > lo
                                 else a[:0, k0:k1], k1)
        if r1 > lo:
            # trailing update of the lower part of this process's rows:
            # columns [k1, r1)
            a[lo - r0:, k1:r1] -= a[lo - r0:, k0:k1] @ strip[:r1 - k1].T
    # the upper triangle is zero; a matrix that is not positive definite
    # gives NaN everywhere, as the serial factor (one all-reduce)
    cols = torch.arange(n, device=a.device)[None, :]
    here = torch.arange(r0, r1, device=a.device)[:, None]
    bad = rows.all_reduce(torch.isnan(a).any().to(a.dtype).reshape(1))
    return torch.where((cols <= here) & (bad == 0), a,
                       torch.where(bad == 0, torch.zeros_like(a),
                                   torch.full_like(a, float("nan"))))


def cholesky(backend, data, block_rows):
    """The lower Cholesky factor of the sharded symmetric positive
    definite DTensor ``data``, laid out by rows (``_Rows``'s placements)."""
    rows = _Rows(backend, data)
    lower = _cholesky_rows(rows, panel_width(block_rows, backend.device))
    return backend.from_local(lower, rows.shape, rows.placements)


def _whole_rhs(backend, rows, b):
    """This process's rows of the right-hand side ``b`` (a DTensor or a
    plain whole tensor, 1-D or 2-D) as a (rows, r) tensor, laid out as
    ``rows``' rows."""
    if mesh_ops.is_dtensor(b):
        pl = tuple(mesh_ops._shard(0) if p.is_shard()
                   else mesh_ops._replicate() for p in rows.placements)
        local = backend.rebox(b, pl).to_local()
        if b.ndim == 2 and any(p.is_shard() and p.dim == 1
                               for p in b.placements):
            raise NotImplementedError(
                "posdef_solve: a right-hand side sharded by columns")
    else:
        local = b[rows.r0:rows.r1]
    return local.reshape(local.shape[0], -1)


def posdef_solve(backend, a, b, block_rows):
    """x of A·x = b for a sharded symmetric positive definite ``a``:
    ``cholesky``, then L·z = b forward and Lᵀ·x = z backward, a panel at a
    time on the row-sharded factor. x is small (b's size) and returned
    whole, the same on every process."""
    rows = _Rows(backend, a)
    width = panel_width(block_rows, backend.device)
    lower = _cholesky_rows(rows, width)
    rhs = _whole_rhs(backend, rows, b).to(lower.dtype)
    n, r = rows.shape[0], int(rhs.shape[1])
    r0 = rows.r0
    z = lower.new_zeros((n, r))
    panels = rows.panels(width)
    for k0, k1, owner in panels:
        if rows.me == owner:
            i = slice(k0 - r0, k1 - r0)
            part = rhs[i] - lower[i, :k0] @ z[:k0]
            z[k0:k1] = torch.linalg.solve_triangular(
                lower[i, k0:k1], part, upper=False)
        seg = z[k0:k1].contiguous()
        rows.broadcast(seg, owner)
        z[k0:k1] = seg
    x = lower.new_zeros((n, r))
    for k0, k1, owner in reversed(panels):
        # Σ over the rows below the panel of L[i, panel]ᵀ x[i]
        lo = max(k1, r0)
        part = lower.new_zeros((k1 - k0, r))
        if rows.r1 > lo:
            part += lower[lo - r0:, k0:k1].T @ x[lo:rows.r1]
        rows.all_reduce(part)
        if rows.me == owner:
            i = slice(k0 - r0, k1 - r0)
            x[k0:k1] = torch.linalg.solve_triangular(
                lower[i, k0:k1].T, z[k0:k1] - part, upper=True)
        seg = x[k0:k1].contiguous()
        rows.broadcast(seg, owner)
        x[k0:k1] = seg
    return x.reshape((n,) + tuple(b.shape[1:]))


def _panel_pivots(strip, used):
    """The pivot rows of a panel, the same on every process: partial
    pivoting's LU of the gathered strip's rows not yet ``used`` (the
    largest |value| of each column after the columns before it, the first
    on ties), as rows of the strip."""
    free = torch.nonzero(~used).reshape(-1)
    _, piv, _ = torch.linalg.lu_factor_ex(strip[free], check_errors=False)
    # LAPACK's pivots are swaps, in order, of 1-based rows
    order = list(range(int(free.numel())))
    for i, p in enumerate(piv.tolist()):
        order[i], order[p - 1] = order[p - 1], order[i]
    return free[torch.as_tensor(order[:strip.shape[1]],
                                device=free.device)]


def inv(backend, data, block_rows):
    """The inverse of the sharded square DTensor ``data``, laid out by
    rows (``_Rows``'s placements), by the blocked Gauss-Jordan of the
    module docstring."""
    rows = _Rows(backend, data)
    n = rows.shape[0]
    width = panel_width(block_rows, backend.device)
    r0, r1 = rows.r0, rows.r1
    local = rows.data.to_local()
    aug = local.new_zeros((r1 - r0, 2 * n))
    aug[:, :n] = local
    here = torch.arange(r1 - r0, device=aug.device)
    aug[here, n + r0 + here] = 1
    used = torch.zeros(n, dtype=torch.bool, device=aug.device)
    pivots = []
    for k0 in range(0, n, width):
        k1 = min(k0 + width, n)
        sel = _panel_pivots(rows.gather_rows(aug[:, k0:k1], 0), used)
        used[sel] = True
        pivots.append(sel)
        mine = (sel >= r0) & (sel < r1)
        prow = aug.new_zeros((k1 - k0, 2 * n - k0))
        prow[mine] = aug[sel[mine] - r0, k0:]
        rows.all_reduce(prow)
        # W = D⁻¹ · (pivot rows), D their panel columns
        w = torch.linalg.solve_ex(prow[:, :k1 - k0], prow,
                                  check_errors=False)[0]
        mult = aug[:, k0:k1].clone()
        aug[:, k0:] -= mult @ w
        at = sel[mine] - r0
        aug[at, k0:] = w[mine]
    # row j of A⁻¹ is the right half of the row that leads column j
    right = backend.from_local(aug[:, n:].contiguous(), rows.shape,
                               rows.placements)
    order = torch.cat(pivots)
    wants = order[r0:r1].reshape(-1, 1)
    coords = backend.coords()

    def every(r):
        a, b = backend.region(rows.shape, rows.placements, coords[r])[0]
        return order[a:b].reshape(-1, 1)

    out = mesh_ops.pull(backend, right, 1, wants, every)
    return backend.from_local(out.contiguous(), rows.shape, rows.placements)



def householder_qr(backend, data, chunk, want_q=True):
    """(this process's rows of Q or None, R whole) of the tall DTensor
    ``data`` by the Householder tree (``settings.tsqr_method``'s
    "householder"), laid out by rows first (``summa.row_layout``); the Q
    rows' placements are ``mesh_ops.rows_only`` of them."""
    from nums_tpu_torch.core.ops import summa

    rows = summa.row_layout(data)
    lead = mesh_ops.rows_only(rows)
    x = summa.local_part(data, rows)
    n = int(x.shape[1])
    lo = backend.region(tuple(data.shape), lead)[0][0]
    if want_q:
        q1, r1 = linalg._direct_tsqr_impl(x, chunk)
    else:
        q1, r1 = None, linalg._tsqr_r_impl(x, chunk)
    heads = multiprocess.all_gather_ints([lo, int(x.shape[0]),
                                          int(r1.shape[0])])
    parts = mesh_ops._all_gather_var(r1.contiguous())
    blocks, at, mine = {}, 0, None
    for (start, m, k), part in sorted(zip(heads.tolist(), parts),
                                      key=lambda e: e[0][0]):
        if m and start not in blocks:  # a replica's rows once
            blocks[start] = (at, part.reshape(int(k), n).to(x.device))
            at += int(k)
    stack = torch.cat([b for _, b in blocks.values()])
    q2, r = linalg._direct_tsqr_impl(stack, chunk)
    if not want_q:
        return None, r
    if x.shape[0]:
        at, block = blocks[lo]
        q = q1 @ q2[at:at + block.shape[0]]
    else:
        q = x.new_zeros((0, int(q2.shape[1])))
    return backend.from_local(q.contiguous(), (int(data.shape[0]),
                                               int(q2.shape[1])), lead), r
