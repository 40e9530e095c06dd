"""Block checkpoints on the local filesystem and in S3, and parallel
text ingestion.

Counterpart of ``nums_tpu/core/io/filesystem.py``. An array on disk is
a directory with one ``.npy`` file per grid block
(``block_<i>_<j>.npy``) and ``meta.pkl`` = ``{"grid": grid.to_meta(),
"checksums": {file name: crc32}}``, byte for byte the format that
``nums_tpu`` writes, so a checkpoint moves between the two packages.

Under several processes (``multiprocess.process_count() > 1``, on a
shared filesystem) every verb is collective, as in the reference: each
process writes only the blocks its region holds (the stored grid is the
mesh's shard grid) into the shared ``.tmp-0`` directories and process 0
publishes; a read loads only the blocks that overlap this process's
region and builds its DTensor with ``MeshBackend.from_local``; process 0
alone deletes and scrubs; ``read_csv`` parses only this process's rows.
Each stage ends in ``multiprocess.checked_barrier``, so a failure on one
process fails them all.

A write is crash-consistent: blocks land in a ``.tmp-<pid>`` directory,
``meta.pkl`` is written last, files and directories are fsynced, and the
directory is published by rename, an earlier version kept as an
``.old-<pid>`` backup until the new one is in place. Readers promote a
complete orphan when a crash fell between the two renames. ``replicas``
> 1 writes full copies beside the primary (or under
``settings.replica_roots``); reads fail over to them block by block,
guarded by the CRCs, and ``verify_fs(repair=True)`` heals a bad copy
from an intact one.

Block files go through the native engine (``shard_native``: a C++ thread
pool, the GIL released) and through ``np.save``/``np.load`` where it is
missing or declines; the files are the same either way.

In S3 an array is one pickled numpy block per object, keyed
``<name>_<i>_<j>``, and the pickled grid under ``<name>_meta``, written
last: the objects nums_tpu writes. boto3 is optional; the fakes of
``fake_s3`` stand in where they are asked for.

``read_csv`` and ``loadtxt`` split a text file into newline-aligned byte
ranges and parse them on parallel threads, the numeric ranges with the
native parser (``_native``), the others with ``np.loadtxt``.
"""

import os
import pickle
import re
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from io import StringIO

import numpy as np
import torch

from nums_tpu_torch.core import multiprocess as _mp
from nums_tpu_torch.core import settings
from nums_tpu_torch.core.array import utils as array_utils
from nums_tpu_torch.core.grid import ArrayGrid, cdiv
from nums_tpu_torch.core.array.blockarray import BlockArray
from nums_tpu_torch.core.io import _native, shard_native

# Blocks fetched from the device and written by one call of the native
# engine: host memory holds this many blocks, not the array.
WRITE_BATCH_BLOCKS = 16


def _fs_path(filename: str) -> str:
    if os.path.isabs(filename):
        return filename
    return os.path.join(settings.data_dir, filename)


def _block_fname(grid_entry: tuple) -> str:
    return "block_" + "_".join(map(str, grid_entry)) + ".npy"


def _block_crc(block: np.ndarray) -> int:
    # The buffer itself, not a bytes copy of it (a block may be 10 GB).
    return zlib.crc32(memoryview(np.ascontiguousarray(block)).cast("B"))


def _replica_paths(final_path: str, count: int):
    """Replica directories of a checkpoint at ``final_path``: with
    ``settings.replica_roots``, replica k mirrors the checkpoint's whole
    absolute path under root[(k-1) % len] (so two checkpoints that share
    a base name never share a replica); without, the siblings
    ``<path>.replica<k>``."""
    roots = settings.replica_roots
    out = []
    mirror = os.path.abspath(final_path).lstrip(os.sep)
    for k in range(1, count):
        if roots:
            root = roots[(k - 1) % len(roots)]
            out.append(os.path.join(root, mirror + f".r{k}"))
        else:
            out.append(f"{final_path}.replica{k}")
    return out


_REPLICA_SIBLING_RE = re.compile(r"\.replica\d+$")
_REPLICA_ROOT_RE = re.compile(r"\.r\d+$")
_ORPHAN_RE = re.compile(r"\.(?:tmp|old)-\d+$")


def _replica_parents(final_path: str):
    """(parent, base name, suffix pattern) of each place a replica of this
    checkpoint can live. The pattern is per scheme (``.replicaN`` beside
    the primary, ``.rN`` under a root), so a user checkpoint named
    ``<base>.r2`` beside the primary is never taken for a replica."""
    out = [(os.path.dirname(final_path) or ".",
            os.path.basename(final_path), _REPLICA_SIBLING_RE)]
    mirror = os.path.abspath(final_path).lstrip(os.sep)
    for root in settings.replica_roots:
        p = os.path.join(root, mirror)
        out.append((os.path.dirname(p), os.path.basename(p),
                    _REPLICA_ROOT_RE))
    return out


def _existing_replicas(final_path: str):
    """Published replica directories (``meta.pkl`` present), found by
    listing the candidate parents, so any replica count is found."""
    found = []
    for parent, base, rep_re in _replica_parents(final_path):
        if not os.path.isdir(parent):
            continue
        for entry in os.listdir(parent):
            if not entry.startswith(base + "."):
                continue
            if not rep_re.fullmatch(entry[len(base):]):
                continue
            full = os.path.join(parent, entry)
            if os.path.isfile(os.path.join(full, "meta.pkl")):
                found.append(full)
    return found


def _live_writer_tmp(suffix: str) -> bool:
    """True when a ``.tmp-<pid>`` suffix names a live process other than
    this one: a concurrent writer, whose directory is not an orphan. Pid
    0 is the multi-process writers' fixed suffix, never a live one."""
    m = re.search(r"\.tmp-(\d+)$", suffix)
    if m is None:
        return False
    pid = int(m.group(1))
    if pid <= 0 or pid == os.getpid():
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _cleanup_orphans(final_path: str, include_replicas: bool = False):
    """Remove the publish orphans (``.tmp-*``, ``.old-*``) of this
    checkpoint and of its replicas; with ``include_replicas`` the
    published replicas too. A live writer's ``.tmp-<pid>`` stays."""
    for parent, base, rep_re in _replica_parents(final_path):
        if not os.path.isdir(parent):
            continue
        for entry in os.listdir(parent):
            if not entry.startswith(base + "."):
                continue
            suffix = entry[len(base):]
            core = _ORPHAN_RE.sub("", suffix)
            is_orphan = _ORPHAN_RE.search(suffix) and (
                core == "" or rep_re.fullmatch(core)
            ) and not _live_writer_tmp(suffix)
            is_replica = include_replicas and rep_re.fullmatch(suffix)
            if is_orphan or is_replica:
                shutil.rmtree(os.path.join(parent, entry),
                              ignore_errors=True)


def _publish_tmps(tmps, targets):
    """Publish complete tmp directories by rename, replicas first, so a
    published primary implies its replicas were written. An existing
    target becomes an ``.old-<pid>`` backup until its successor is in
    place; a reader's recovery may promote the tmp in between, and a
    complete target then counts as published."""
    for t, p in list(zip(tmps, targets))[::-1]:
        if os.path.isdir(p):
            trash = f"{p}.old-{os.getpid()}"
            shutil.rmtree(trash, ignore_errors=True)
            os.rename(p, trash)
            try:
                os.rename(t, p)
            except OSError:
                if not os.path.isfile(os.path.join(p, "meta.pkl")):
                    raise
            shutil.rmtree(trash, ignore_errors=True)
        else:
            try:
                os.rename(t, p)
            except OSError:
                if not os.path.isfile(os.path.join(p, "meta.pkl")):
                    raise


def _fsync_path(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_tree(path: str):
    """fsync every file of ``path`` and the directory itself, so a renamed
    checkpoint survives power loss (``settings.checkpoint_fsync``)."""
    if not settings.checkpoint_fsync:
        return
    for entry in os.listdir(path):
        full = os.path.join(path, entry)
        if os.path.isfile(full):
            _fsync_path(full)
    _fsync_path(path)


def _write_meta(tmp: str, meta: dict):
    """``meta.pkl`` (the completeness marker), then the fsync of the
    directory."""
    with open(os.path.join(tmp, "meta.pkl"), "wb") as f:
        f.write(pickle.dumps(meta))
        f.flush()
        if settings.checkpoint_fsync:
            os.fsync(f.fileno())
    _fsync_tree(tmp)


def _recover_fs_dir(path: str) -> bool:
    """Promote a complete orphan when ``path`` vanished mid-publish (a
    crash between the rename to ``.old-*`` and the rename of ``.tmp-*``):
    the newest complete ``.tmp-*``, else the ``.old-*`` backup. True when
    ``path`` is (now) a complete checkpoint."""
    if os.path.isfile(os.path.join(path, "meta.pkl")):
        return True
    base = os.path.basename(path)
    parent = os.path.dirname(path) or "."
    if not os.path.isdir(parent):
        return False
    candidates = []
    for entry in os.listdir(parent):
        if not entry.startswith(base + "."):
            continue
        suffix = entry[len(base):]
        if not (suffix.startswith(".tmp-") or suffix.startswith(".old-")):
            continue
        full = os.path.join(parent, entry)
        meta = os.path.join(full, "meta.pkl")
        if os.path.isfile(meta):
            rank = (suffix.startswith(".tmp-"), os.path.getmtime(meta))
            candidates.append((rank, full))
    if not candidates:
        return False
    candidates.sort()
    try:
        os.rename(candidates[-1][1], path)
    except OSError:
        pass  # raced another reader's recovery or a writer's publish
    return os.path.isfile(os.path.join(path, "meta.pkl"))


def _host_block(data, grid: ArrayGrid, grid_entry: tuple) -> np.ndarray:
    """One block of ``data`` (a tensor in logical layout) as a C-ordered
    host array: only that block leaves the device. A 0-d array's block
    has shape (1,), as nums_tpu's block writer stores it. A DTensor here
    is on a mesh of this process alone, which holds all of it."""
    from torch.distributed.tensor import DTensor

    if isinstance(data, DTensor):
        data = data.to_local()
    return np.ascontiguousarray(
        data[grid.get_slice(grid_entry)].cpu().numpy())


def _place(out, dst, blk):
    """out[dst] = blk, where a 0-d ``out`` takes its (1,) block."""
    out[dst] = blk.reshape(()) if out.ndim == 0 else blk


def row_region_loader(logical_shape, dtype, fill_rows):
    """A region loader over a 2-D row-major source for
    :func:`region_array`: allocates the box and hands the rows and columns
    it covers to ``fill_rows(r0, r1, c0, c1, out)`` (skipped for an empty
    box). The multi-process CSV and Parquet readers share it. The
    reference's also zero-fills the pad rows of its padded layout; the
    port's uneven shards have none."""
    n, d = logical_shape

    def load_region(box):
        (r0, r1), (c0, c1) = box
        out = np.zeros((r1 - r0, c1 - c0), dtype=dtype)
        if r0 < min(r1, n) and c0 < min(c1, d):
            fill_rows(r0, r1, c0, c1, out)
        return out

    return load_region


def region_array(backend, grid: ArrayGrid, load_region) -> BlockArray:
    """The BlockArray of ``grid`` on a mesh backend, built from this
    process's region alone: ``load_region(box)`` returns the host values
    of the box ((start, stop) per axis) that the grid's placement gives
    this process, which go to its device as the local part of a DTensor
    (``from_local``, no communication). The reference's
    ``jax.make_array_from_callback``."""
    placements = backend.sharding_for_grid(grid)
    box = backend.region(grid.shape, placements)
    host = np.asarray(load_region(box))
    host = host.astype(backend.device_dtype(host.dtype), copy=False)
    local = torch.from_numpy(np.ascontiguousarray(host)).to(backend.device)
    data = backend.from_local(local, grid.shape, placements)
    return BlockArray(data, ArrayGrid(grid.shape, grid.block_shape,
                                      array_utils.to_dtype_name(
                                          local.dtype)), backend)


def _overlaps(grid: ArrayGrid, box):
    """(grid entry, src, dst) for each stored block that overlaps ``box``:
    ``src`` the window of the block, ``dst`` its place in the box."""
    starts = [a for a, _ in box]
    stops = [b for _, b in box]
    out = []
    for entry in grid.get_entry_iterator():
        rect = grid.get_slice_tuples(entry)
        lo = [max(a, r0) for a, (r0, _) in zip(starts, rect)]
        hi = [min(b, r1) for b, (_, r1) in zip(stops, rect)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        src = tuple(slice(l - r0, h - r0)
                    for l, h, (r0, _) in zip(lo, hi, rect))
        dst = tuple(slice(l - a, h - a) for l, h, a in zip(lo, hi, starts))
        out.append((entry, src, dst))
    return out


def _tag(filename: str) -> str:
    return filename.replace(os.sep, "_")


def _s3_parse(filename: str):
    assert not filename.startswith("s3://"), "pass keys without scheme"
    bucket, _, key = filename.partition("/")
    return bucket, key


def _s3_block_key(key: str, grid_entry: tuple) -> str:
    return f"{key}_" + "_".join(map(str, grid_entry))


class FileSystem:
    """Block I/O and text ingestion of one process."""

    def __init__(self, backend):
        self.backend = backend

    def write_fs(self, ba: BlockArray, filename: str, replicas: int = None):
        """Crash-consistent, optionally replicated write of ``ba``: a
        batch of blocks at a time leaves the device and is written by the
        native engine (``np.save`` where it declines), so host memory
        holds one batch. Returns one True per block."""
        if replicas is None:
            replicas = settings.checkpoint_replicas
        if _mp.is_multiprocess():
            return self._write_fs_multiprocess(ba, filename, replicas)
        final_path = _fs_path(filename)
        targets = [final_path] + _replica_paths(final_path, max(1, replicas))
        tmps = [f"{p}.tmp-{os.getpid()}" for p in targets]
        for t in tmps:
            if os.path.isdir(t):
                shutil.rmtree(t)
            os.makedirs(t, exist_ok=True)
        data = ba.data
        checksums = {}
        entries = list(ba.grid.get_entry_iterator())
        for i in range(0, len(entries), WRITE_BATCH_BLOCKS):
            batch = entries[i:i + WRITE_BATCH_BLOCKS]
            blocks = [_host_block(data, ba.grid, e) for e in batch]
            for e, blk in zip(batch, blocks):
                checksums[_block_fname(e)] = _block_crc(blk)
            items = [(os.path.join(t, _block_fname(e)), blk)
                     for t in tmps for e, blk in zip(batch, blocks)]
            if not shard_native.write_shards(items):
                for p, blk in items:
                    np.save(p, blk)
        meta = {"grid": ba.grid.to_meta(), "checksums": checksums}
        for t in tmps:
            _write_meta(t, meta)
        _publish_tmps(tmps, targets)
        _cleanup_orphans(final_path)
        if settings.checkpoint_fsync:
            _fsync_path(os.path.dirname(final_path) or ".")
        # Replicas of an earlier, more replicated write would serve
        # outdated blocks to the failover.
        for stale in _existing_replicas(final_path):
            if stale not in targets:
                shutil.rmtree(stale, ignore_errors=True)
        return np.ones(len(entries), dtype=bool)

    def _shard_grid_blocks(self, ba: BlockArray):
        """(grid, [(entry, host block)]) for the multi-process writers.

        The stored grid is the shard grid of the value's placement: along
        each axis, blocks of ceil(n / m) where m devices shard it, clipped
        to the logical shape, trailing empty shards dropped, the
        reference's rule. DTensor's uneven shards are exactly those
        blocks (``torch.chunk`` extents: ceil(n / m), then the rest), so
        each distinct region is one block, claimed by the lowest rank that
        holds it (``multiprocess.owned_regions``); the names and shapes
        are the reference's. Where an axis is split by several mesh
        dimensions in turn (a 1-D array over a 2-D mesh), DTensor's
        regions are not that grid's blocks: the value is gathered
        (collective) and block i is written by process i mod P."""
        backend = self.backend
        logical = tuple(ba.grid.shape)
        if backend.mesh is None:  # a whole array on every process
            grid = ba.grid
            blocks = []
            if _mp.process_index() == 0:
                data = ba.data
                blocks = [(e, _host_block(data, grid, e))
                          for e in grid.get_entry_iterator()]
            return grid, blocks
        # The value as it is laid out (a lazy transpose keeps its
        # buffer's sharding, as the reference's writer does).
        from torch.distributed.tensor import DTensor

        data = ba.data
        if not isinstance(data, DTensor):
            data = backend.place(data, ba.grid)
        want = tuple(data.placements)
        mesh_shape = backend.device_grid.mesh_shape
        parts = [1] * len(logical)
        for j, p in enumerate(want):
            if p.is_shard():
                parts[p.dim] *= mesh_shape[j]
        block_shape = tuple(min(cdiv(n, m), n) if n else 0
                            for n, m in zip(logical, parts))
        grid = ArrayGrid(logical, block_shape, ba.grid.dtype)
        if not logical:
            return grid, [((), _host_block(_mp.sent_gather(data).full_tensor(),
                                           grid, ()))
                          ] if _mp.process_index() == 0 else []

        def is_block(box):
            return all(a == b or (a % bs == 0 and b == min(a + bs, n))
                       for (a, b), bs, n in zip(box, block_shape, logical))

        import itertools

        boxes = [backend.region(logical, want, c) for c in
                 itertools.product(*(range(m) for m in mesh_shape))]
        if all(is_block(b) for b in boxes):
            blocks = []
            for index, arr in _mp.owned_regions(data):
                entry = tuple(s.start // bs
                              for s, bs in zip(index, block_shape))
                blocks.append((entry, np.ascontiguousarray(arr)))
            return grid, blocks
        full = _mp.sent_gather(data).full_tensor()
        rank, world = _mp.process_index(), _mp.process_count()
        return grid, [(e, _host_block(full, grid, e)) for i, e in
                      enumerate(grid.get_entry_iterator())
                      if i % world == rank]

    def _write_fs_multiprocess(self, ba: BlockArray, filename: str,
                               replicas: int):
        """The collective checkpoint write (every process calls it; the
        filesystem is shared). Each process writes only its own blocks
        (``_shard_grid_blocks``), in every copy, into the shared
        ``.tmp-0`` directories (the fixed suffix ``_cleanup_orphans`` and
        ``_recover_fs_dir`` treat as a serial write's) with a CRC sidecar;
        process 0 merges the sidecars into ``meta.pkl`` and publishes.
        Every stage ends in a checked barrier. Returns one True per block
        this process wrote (``[True]`` where it wrote none)."""
        final_path = _fs_path(filename)
        targets = [final_path] + _replica_paths(final_path, max(1, replicas))
        tmps = [f"{p}.tmp-0" for p in targets]
        tag = _tag(filename)
        what = f"write_fs({filename!r})"
        grid, owned = self._shard_grid_blocks(ba)

        def prepare():
            for t in tmps:
                if os.path.isdir(t):
                    shutil.rmtree(t)
                os.makedirs(t, exist_ok=True)

        _mp.stage(f"write_fs:prepare:{tag}", what + " prepare", prepare,
                  only0=True)

        def write_blocks():
            checksums = {}
            items = []
            for entry, block in owned:
                fname = _block_fname(entry)
                checksums[fname] = _block_crc(block)
                items.extend((os.path.join(t, fname), block) for t in tmps)
            if items and not shard_native.write_shards(items):
                for p, blk in items:
                    np.save(p, blk)
            side = f"checksums.{_mp.process_index()}.pkl"
            for t in tmps:
                with open(os.path.join(t, side), "wb") as f:
                    f.write(pickle.dumps(checksums))

        _mp.stage(f"write_fs:blocks:{tag}", what + " blocks", write_blocks)

        def publish():
            merged = {}
            for entry in sorted(os.listdir(tmps[0])):
                if entry.startswith("checksums.") and entry.endswith(".pkl"):
                    with open(os.path.join(tmps[0], entry), "rb") as f:
                        merged.update(pickle.load(f))
            for t in tmps:
                for entry in os.listdir(t):
                    if entry.startswith("checksums."):
                        os.remove(os.path.join(t, entry))
                _write_meta(t, {"grid": grid.to_meta(), "checksums": merged})
            _publish_tmps(tmps, targets)
            _cleanup_orphans(final_path)
            if settings.checkpoint_fsync:
                _fsync_path(os.path.dirname(final_path) or ".")
            for stale in _existing_replicas(final_path):
                if stale not in targets:
                    shutil.rmtree(stale, ignore_errors=True)

        _mp.stage(f"write_fs:publish:{tag}", what + " publish", publish,
                  only0=True)
        return np.ones(max(1, len(owned)), dtype=bool)

    def read_meta_fs(self, filename: str) -> dict:
        path = _fs_path(filename)
        _recover_fs_dir(path)
        err = None
        for d in [path] + _existing_replicas(path):
            try:
                with open(os.path.join(d, "meta.pkl"), "rb") as f:
                    return pickle.load(f)
            except Exception as e:  # a torn primary: fail over
                err = err or e
        raise err if err is not None else FileNotFoundError(path)

    @staticmethod
    def _load_block_checked(primary, alt_dirs, checks):
        """The whole block from the first intact copy (the primary, then
        the replicas); ``checks`` (file name -> crc32) rejects a silently
        corrupted copy, None accepts any copy that loads."""
        fname = os.path.basename(primary)
        want = checks.get(fname) if checks else None
        for d in [os.path.dirname(primary)] + alt_dirs:
            try:
                arr = np.load(os.path.join(d, fname))
            except Exception:
                continue
            if want is not None and _block_crc(arr) != want:
                continue
            return arr
        raise IOError(
            f"no intact copy of {fname} in {1 + len(alt_dirs)} location(s)"
        )

    def read_fs(self, filename: str, verify: bool = False) -> BlockArray:
        """The array, assembled in host memory and placed on the device
        once, with the stored block shape. The native engine reads every
        block straight into its window of the host buffer; when it
        declines or any read fails, and under ``verify=True`` (a window
        read cannot checksum), blocks load one by one: a primary that is
        missing or does not load fails over to the replicas (always
        CRC-guarded), and ``verify`` CRC-checks the primaries too."""
        path = _fs_path(filename)
        meta = self.read_meta_fs(filename)
        alt_dirs = _existing_replicas(path)
        checks = meta.get("checksums")
        grid = ArrayGrid.from_meta(meta["grid"])
        if (_mp.is_multiprocess() and self.backend.mesh is not None
                and grid.shape):
            return self._read_fs_region(path, grid, alt_dirs, checks,
                                        verify)
        out = np.zeros(grid.shape, dtype=np.dtype(grid.dtype))
        jobs = []
        for entry in grid.get_entry_iterator():
            dst = grid.get_slice(entry)
            src = tuple(slice(0, s.stop - s.start) for s in dst)
            jobs.append((os.path.join(path, _block_fname(entry)), src, dst))
        if verify or not shard_native.read_block_windows(jobs, out):
            for p, _, dst in jobs:
                if not verify:
                    try:
                        _place(out, dst, np.load(p))
                        continue
                    except Exception:
                        pass  # fail over to the replicas
                _place(out, dst,
                       self._load_block_checked(p, alt_dirs, checks))
        return BlockArray.from_np(out, block_shape=grid.block_shape,
                                  backend=self.backend)

    def _read_fs_region(self, path, grid, alt_dirs, checks, verify):
        """``read_fs`` under several processes (collective): this process
        loads only the stored blocks that overlap its region, windows read
        by the native engine, or whole blocks with the replica failover
        and CRCs (``verify``), and builds its part of the DTensor
        (``region_array``). No process assembles the whole array, and any
        stored grid reads under any mesh."""
        dtype = np.dtype(grid.dtype)

        def load_region(box):
            out = np.zeros(tuple(b - a for a, b in box), dtype=dtype)
            jobs = [(os.path.join(path, _block_fname(e)), src, dst)
                    for e, src, dst in _overlaps(grid, box)]
            if verify or not shard_native.read_block_windows(jobs, out):
                for p, src, dst in jobs:
                    if not verify:
                        try:
                            out[dst] = np.load(p, mmap_mode="r")[src]
                            continue
                        except Exception:
                            pass  # fail over to the replicas
                    out[dst] = self._load_block_checked(
                        p, alt_dirs, checks)[src]
            return out

        what = f"read_fs({path!r})"
        arr = _mp.stage(f"read_fs:{_tag(path)}", what,
                        lambda: region_array(self.backend, grid,
                                             load_region))
        return arr

    def delete_fs(self, filename: str):
        """Delete the checkpoint, its replicas and its publish orphans (an
        orphan left behind would bring the checkpoint back on the next
        read). Returns ``[existed]``. Under several processes it is
        collective: every process looks before any deletes, so all return
        the same flag, and process 0 alone deletes (rmtrees racing on a
        shared filesystem fail each other)."""
        path = _fs_path(filename)
        if _mp.is_multiprocess():
            exists = os.path.isdir(path)
            _mp.barrier(f"delete_fs:probe:{_tag(filename)}")

            def remove():
                _cleanup_orphans(path, include_replicas=True)
                if exists:
                    shutil.rmtree(path)

            _mp.stage(f"delete_fs:done:{_tag(filename)}",
                      f"delete_fs({filename!r})", remove, only0=True)
            return np.array([exists], dtype=bool)
        _cleanup_orphans(path, include_replicas=True)
        exists = os.path.isdir(path)
        if exists:
            shutil.rmtree(path)
        return np.array([exists], dtype=bool)

    def verify_fs(self, filename: str, repair: bool = False) -> dict:
        """CRC-check every copy of every block against the checksums of
        the write. ``repair=True`` rewrites each bad copy from an intact
        copy of the same block (an atomic replace per file). Returns::

            {"ok": bool,            # every copy of every block intact
             "blocks": int,
             "copies": int,         # locations checked per block
             "bad": [(dir, fname)], # failures found (before repair)
             "repaired": [(dir, fname)],
             "unrecoverable": [fname]}  # no intact copy anywhere

        ``repair=True`` under several processes is collective: process 0
        scrubs (repairers racing on the same files would clash, and a
        scrub on every process reads every copy P times) and leaves its
        report in a sidecar on the shared filesystem, which every process
        reads, so all return the same report.
        """
        if repair and _mp.is_multiprocess():
            tag = _tag(filename)
            sidecar = _fs_path(filename) + ".scrub-report.pkl"
            what = f"verify_fs({filename!r})"

            def scrub():
                report = self._verify_fs_impl(filename, True)
                tmp = f"{sidecar}.tmp-{os.getpid()}"
                with open(tmp, "wb") as f:
                    f.write(pickle.dumps(report))
                os.replace(tmp, sidecar)

            _mp.stage(f"verify_fs:scrub:{tag}", what + " scrub", scrub,
                      only0=True)

            def read_report():
                with open(sidecar, "rb") as f:
                    return pickle.load(f)

            report = _mp.stage(f"verify_fs:read:{tag}", what + " report",
                               read_report)
            if _mp.process_index() == 0:
                try:
                    os.remove(sidecar)
                except OSError:
                    pass
            return report
        return self._verify_fs_impl(filename, repair)

    def _verify_fs_impl(self, filename: str, repair: bool) -> dict:
        path = _fs_path(filename)
        meta = self.read_meta_fs(filename)
        checks = meta.get("checksums") or {}
        dirs = [path] + _existing_replicas(path)
        bad, repaired, unrecoverable = [], [], []
        for fname, want in checks.items():
            intact = None
            failures = []
            for d in dirs:
                try:
                    arr = np.load(os.path.join(d, fname))
                    if _block_crc(arr) != want:
                        raise IOError("crc mismatch")
                except Exception:
                    failures.append(d)
                    continue
                if intact is None:
                    intact = arr
            bad.extend((d, fname) for d in failures)
            if failures and intact is None:
                unrecoverable.append(fname)
            elif failures and repair:
                for d in failures:
                    os.makedirs(d, exist_ok=True)
                    # np.save appends .npy to a name without it.
                    tmp = os.path.join(d, f".{fname}.tmp-{os.getpid()}.npy")
                    np.save(tmp, intact)
                    os.replace(tmp, os.path.join(d, fname))
                    repaired.append((d, fname))
        return {
            "ok": not bad,
            "blocks": len(checks),
            "copies": len(dirs),
            "bad": bad,
            "repaired": repaired,
            "unrecoverable": unrecoverable,
        }

    def exists_fs(self, filename: str) -> bool:
        return _recover_fs_dir(_fs_path(filename))

    # -- S3 -------------------------------------------------------------

    # A callable that returns the client, for tests and other object
    # stores. When None: the fakes where the environment asks for them,
    # else boto3.
    s3_client_factory = None

    def _s3_client(self):
        if FileSystem.s3_client_factory is not None:
            return FileSystem.s3_client_factory()
        # A fake that was asked for outranks an importable boto3: a test
        # that sets NUMS_TPU_TORCH_FAKE_S3_DIR must never reach real S3.
        fake_dir = os.environ.get("NUMS_TPU_TORCH_FAKE_S3_DIR")
        if fake_dir:
            from nums_tpu_torch.core.io.fake_s3 import FileBackedFakeS3Client

            return FileBackedFakeS3Client(fake_dir)
        if os.environ.get("NUMS_TPU_TORCH_FAKE_S3") == "1":
            from nums_tpu_torch.core.io.fake_s3 import FakeS3Client

            return FakeS3Client()
        try:
            import boto3
        except ImportError:
            raise RuntimeError(
                "boto3 is not available; S3 I/O is disabled in this build "
                "(set NUMS_TPU_TORCH_FAKE_S3=1 for the in-process fake)."
            ) from None
        return boto3.client("s3")

    def write_s3(self, ba: BlockArray, filename: str):
        """One object per block (a pickled C-ordered numpy array, which
        nums_tpu reads too), then the grid's meta object: readers key on
        it, so a writer that fails midway never exposes a grid with
        missing blocks. Returns one True per block."""
        if _mp.is_multiprocess():
            return self._write_s3_multiprocess(ba, filename)
        client = self._s3_client()
        bucket, key = _s3_parse(filename)
        data = ba.data
        results = []
        for grid_entry in ba.grid.get_entry_iterator():
            block = _host_block(data, ba.grid, grid_entry)
            client.put_object(
                Bucket=bucket, Key=_s3_block_key(key, grid_entry),
                Body=pickle.dumps(block),
            )
            results.append(True)
        meta = {"grid": ba.grid.to_meta()}
        client.put_object(
            Bucket=bucket, Key=f"{key}_meta", Body=pickle.dumps(meta)
        )
        return np.array(results, dtype=bool)

    def _write_s3_multiprocess(self, ba: BlockArray, filename: str):
        """The collective S3 write: each process puts only the objects of
        its own blocks (``_shard_grid_blocks``, the checkpoint writer's
        grid); after a checked barrier, process 0 puts the meta object, on
        which readers key, so none sees a grid whose blocks are not all
        there. Puts are atomic per key: no rename. Returns one True per
        object this process put (``[True]`` where it put none)."""
        client = self._s3_client()
        bucket, key = _s3_parse(filename)
        grid, owned = self._shard_grid_blocks(ba)
        what = f"write_s3({filename!r})"

        def put_blocks():
            for entry, block in owned:
                client.put_object(Bucket=bucket,
                                  Key=_s3_block_key(key, entry),
                                  Body=pickle.dumps(block))

        _mp.stage(f"write_s3:blocks:{_tag(key)}", what + " blocks",
                  put_blocks)
        _mp.stage(f"write_s3:meta:{_tag(key)}", what + " meta",
                  lambda: client.put_object(
                      Bucket=bucket, Key=f"{key}_meta",
                      Body=pickle.dumps({"grid": grid.to_meta()})),
                  only0=True)
        return np.ones(max(1, len(owned)), dtype=bool)

    def read_meta_s3(self, filename: str) -> dict:
        client = self._s3_client()
        bucket, key = _s3_parse(filename)
        obj = client.get_object(Bucket=bucket, Key=f"{key}_meta")
        return pickle.loads(obj["Body"].read())

    def read_s3(self, filename: str) -> BlockArray:
        """The array, assembled on the host block by block and placed on
        the device once, with the stored block shape."""
        client = self._s3_client()
        bucket, key = _s3_parse(filename)
        grid = ArrayGrid.from_meta(self.read_meta_s3(filename)["grid"])
        if (_mp.is_multiprocess() and self.backend.mesh is not None
                and grid.shape):
            # Collective: each process fetches only the objects that
            # overlap its region.
            def load_region(box):
                out = np.zeros(tuple(b - a for a, b in box),
                               dtype=np.dtype(grid.dtype))
                for entry, src, dst in _overlaps(grid, box):
                    obj = client.get_object(
                        Bucket=bucket, Key=_s3_block_key(key, entry))
                    out[dst] = pickle.loads(obj["Body"].read())[src]
                return out

            return _mp.stage(f"read_s3:{_tag(key)}", f"read_s3({filename!r})",
                             lambda: region_array(self.backend, grid,
                                                  load_region))
        out = np.zeros(grid.shape, dtype=np.dtype(grid.dtype))
        for grid_entry in grid.get_entry_iterator():
            obj = client.get_object(
                Bucket=bucket, Key=_s3_block_key(key, grid_entry))
            _place(out, grid.get_slice(grid_entry),
                   pickle.loads(obj["Body"].read()))
        return BlockArray.from_np(out, block_shape=grid.block_shape,
                                  backend=self.backend)

    def delete_s3(self, filename: str):
        """Delete the array's objects. Under several processes process 0
        deletes, after every process has read the grid (collective)."""
        client = self._s3_client()
        bucket, key = _s3_parse(filename)
        grid = ArrayGrid.from_meta(self.read_meta_s3(filename)["grid"])
        keys = [f"{key}_meta"] + [
            _s3_block_key(key, e) for e in grid.get_entry_iterator()
        ]

        def remove():
            # DeleteObjects takes at most 1000 keys per request.
            for i in range(0, len(keys), 1000):
                client.delete_objects(
                    Bucket=bucket,
                    Delete={"Objects": [{"Key": k}
                                        for k in keys[i:i + 1000]]},
                )

        if _mp.is_multiprocess():
            _mp.barrier(f"delete_s3:probe:{_tag(key)}")
            _mp.stage(f"delete_s3:done:{_tag(key)}",
                      f"delete_s3({filename!r})", remove, only0=True)
        else:
            remove()
        return np.array([True] * len(keys), dtype=bool)

    # -- parallel text ingestion ----------------------------------------

    def _byte_ranges(self, filename: str, num_workers: int):
        """Split a file into at most ``num_workers`` byte ranges, each
        starting just after a newline."""
        size = os.path.getsize(filename)
        num_workers = max(1, min(num_workers, size))
        approx = size // num_workers
        offsets = [0]
        with open(filename, "rb") as f:
            for i in range(1, num_workers):
                pos = i * approx
                if pos <= offsets[-1]:
                    continue
                f.seek(pos)
                f.readline()  # on to the next line's first byte
                aligned = f.tell()
                if aligned < size:
                    offsets.append(aligned)
        offsets.append(size)
        return [
            (offsets[i], offsets[i + 1]) for i in range(len(offsets) - 1)
        ]

    def _default_workers(self) -> int:
        return max(self.backend.num_devices, os.cpu_count() or 1)

    def _read_csv_multiprocess(self, filename, dtype, delimiter,
                               has_header) -> BlockArray:
        """``read_csv`` under several processes (collective; a shared
        filesystem). The file is cut into newline-aligned byte ranges whose
        non-blank lines the processes count round-robin (one all-reduce of
        the counts); then each process finds the byte span of its region's
        rows and parses that span alone with the native parser
        (``np.loadtxt`` where it declines), so each reads about 1/P of the
        file. Every line is one data row."""
        nproc, pidx = _mp.process_count(), _mp.process_index()
        size = os.path.getsize(filename)
        ranges = self._byte_ranges(filename, max(16, 4 * nproc))
        counts = np.zeros(len(ranges), np.int64)
        with open(filename, "rb") as f:
            for i in range(pidx, len(ranges), nproc):
                start, stop = ranges[i]
                f.seek(start)
                # Non-blank lines only: the parsers skip blank ones. The
                # last part is the unterminated tail of the file's last
                # range (a row if not blank), else b"".
                parts = f.read(stop - start).split(b"\n")
                counts[i] = sum(1 for ln in parts[:-1] if ln.strip())
                counts[i] += 1 if parts[-1].strip() else 0
        counts = _mp.host_sum(counts)
        cum = np.concatenate([[0], np.cumsum(counts)])
        header = 1 if has_header else 0
        total_rows = int(cum[-1]) - header
        assert total_rows > 0, f"{filename}: no data rows"
        with open(filename, "rb") as f:
            line = f.readline()
            if has_header:
                line = f.readline()
        ncols = len(line.decode().strip().split(delimiter))
        out_dtype = np.dtype(dtype)
        block_shape = (max(1, total_rows // max(1, self.backend.num_devices)),
                       ncols)
        grid = ArrayGrid((total_rows, ncols), block_shape, out_dtype.name)

        def line_offset(f, line_idx):
            """The byte offset of non-blank line ``line_idx``: its range
            from the counts, then a scan of that range."""
            if line_idx >= cum[-1]:
                return size
            i = int(np.searchsorted(cum, line_idx, side="right")) - 1
            start, stop = ranges[i]
            need = int(line_idx - cum[i])
            f.seek(start)
            raw = f.read(stop - start)
            ofs, seen = 0, 0
            while ofs <= len(raw):
                nl = raw.find(b"\n", ofs)
                end = nl if nl >= 0 else len(raw)
                if raw[ofs:end].strip():
                    if seen == need:
                        return start + ofs
                    seen += 1
                if nl < 0:
                    break
                ofs = nl + 1
            return stop

        def fill_rows(r0, r1, c0, c1, out):
            with open(filename, "rb") as f:
                b0 = line_offset(f, header + r0)
                b1 = line_offset(f, header + r1)
                f.seek(b0)
                raw = f.read(b1 - b0)
            arr, ok = _native.parse_bytes(raw, delimiter)
            if not ok:
                arr = np.loadtxt(StringIO(raw.decode()), dtype=out_dtype,
                                 delimiter=delimiter, ndmin=2)
            arr = arr.astype(out_dtype, copy=False)
            assert arr.shape == (r1 - r0, ncols), (
                arr.shape, (r1 - r0, ncols), "malformed CSV region")
            out[:, :] = arr[:, c0:c1]

        load_region = row_region_loader((total_rows, ncols), out_dtype,
                                        fill_rows)
        return _mp.stage(f"read_csv:{_tag(filename)}",
                         f"read_csv({filename!r})",
                         lambda: region_array(self.backend, grid,
                                              load_region))

    def read_csv(
        self, filename, dtype=float, delimiter=",", has_header=False,
        num_workers=None,
    ) -> BlockArray:
        if _mp.is_multiprocess() and self.backend.mesh is not None:
            return self._read_csv_multiprocess(filename, dtype, delimiter,
                                               has_header)
        arr = self.read_csv_host(
            filename, dtype=dtype, delimiter=delimiter,
            has_header=has_header, num_workers=num_workers,
        )
        block_shape = (
            max(1, arr.shape[0] // max(1, self.backend.num_devices)),
            arr.shape[1],
        )
        return BlockArray.from_np(
            arr, block_shape=block_shape, backend=self.backend
        )

    def read_csv_host(
        self, filename, dtype=float, delimiter=",", has_header=False,
        num_workers=None,
    ) -> np.ndarray:
        """The host stage of :meth:`read_csv`, without the placement on
        the device, so a caller can time the parse apart from the copy.

        With the native parser every byte range parses straight into its
        slice of one buffer sized for the whole file (parallel threads,
        the GIL released): no concatenation. A range that is not purely
        numeric, or rows of unequal width, send the file to the per-range
        ``np.loadtxt`` route, which decides what the text means."""
        if num_workers is None:
            num_workers = self._default_workers()
        ranges = self._byte_ranges(filename, num_workers)
        workers = min(32, len(ranges))

        def load(rng):
            start, stop = rng
            with open(filename, "rb") as f:
                f.seek(start)
                raw = f.read(stop - start)
            if start == 0 and has_header:
                nl = raw.find(b"\n")
                raw = raw[nl + 1:] if nl >= 0 else b""
            return raw if raw.strip() else b""

        arr = None
        if _native.get_lib() is not None:
            with ThreadPoolExecutor(max_workers=workers) as ex:
                raws = list(ex.map(load, ranges))
            counts = [_native.count_values(r, delimiter) for r in raws]
            offs = np.zeros(len(counts) + 1, np.int64)
            np.cumsum(counts, out=offs[1:])
            out = np.empty(int(offs[-1]), np.float64)

            def parse_into(i):
                if not raws[i]:
                    return 0, 0, 0, True
                return _native.parse_bytes_into(
                    raws[i], delimiter, out[offs[i]:offs[i + 1]]
                )

            with ThreadPoolExecutor(max_workers=workers) as ex:
                results = list(ex.map(parse_into, range(len(raws))))
            del raws
            cols = {c for _, _, c, ok in results if ok and c}
            if all(ok for *_, ok in results) and len(cols) == 1:
                # The count is an upper bound where lines are blank or
                # end in a delimiter: close the gaps that leaves.
                pos = 0
                for (n, _, _, _), lo in zip(results, offs):
                    if n and lo != pos:
                        out[pos:pos + n] = out[lo:lo + n]
                    pos += n
                arr = out[:pos].reshape(-1, cols.pop())
                if np.dtype(dtype) != arr.dtype:
                    arr = arr.astype(dtype)

        if arr is None:
            def parse(rng):
                raw = load(rng)
                if not raw:
                    return None
                a, ok = _native.parse_bytes(raw, delimiter)
                if ok:
                    return (
                        a if np.dtype(dtype) == a.dtype else a.astype(dtype)
                    )
                return np.loadtxt(
                    StringIO(raw.decode()), dtype=dtype,
                    delimiter=delimiter, ndmin=2,
                )

            with ThreadPoolExecutor(max_workers=workers) as ex:
                parts = [
                    p for p in ex.map(parse, ranges)
                    if p is not None and p.size
                ]
            if not parts:
                raise ValueError(
                    f"{filename}: no data rows (empty or blank file)"
                )
            arr = (
                np.concatenate(parts, axis=0) if len(parts) > 1
                else parts[0]
            )
        return arr

    def loadtxt(
        self, fname, dtype=float, comments="# ", delimiter=" ",
        converters=None, skiprows=0, usecols=None, unpack=False, ndmin=0,
        encoding="bytes", max_rows=None, num_workers=None,
    ) -> BlockArray:
        """``np.loadtxt`` into a BlockArray. The simple argument
        combinations split the file into newline-aligned byte ranges
        parsed on parallel threads; converters, usecols, unpack, ndmin,
        skiprows and max_rows take numpy's one call, for its exact
        meaning."""
        simple = (
            converters is None and usecols is None and not unpack
            and ndmin == 0 and skiprows == 0 and max_rows is None
        )
        if not simple:
            arr = np.loadtxt(
                fname, dtype=dtype, comments=comments, delimiter=delimiter,
                converters=converters, skiprows=skiprows, usecols=usecols,
                unpack=unpack, ndmin=ndmin, encoding=encoding,
                max_rows=max_rows,
            )
            return BlockArray.from_np(arr, backend=self.backend)

        if num_workers is None:
            num_workers = self._default_workers()
        ranges = self._byte_ranges(fname, num_workers)

        def parse(rng):
            start, stop = rng
            with open(fname, "rb") as f:
                f.seek(start)
                raw = f.read(stop - start)
            if not raw.strip():
                return None
            return np.loadtxt(
                StringIO(raw.decode()), dtype=dtype, comments=comments,
                delimiter=delimiter, ndmin=2,
            )

        with ThreadPoolExecutor(max_workers=min(32, len(ranges))) as ex:
            parts = [
                p for p in ex.map(parse, ranges) if p is not None and p.size
            ]
        if not parts:
            raise ValueError(f"{fname}: no data rows (empty or blank file)")
        arr = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        # np.loadtxt with ndmin=0 squeezes every axis of size 1: one row
        # gives (n,), one column (m,), one value a 0-d array.
        return BlockArray.from_np(np.squeeze(arr), backend=self.backend)
