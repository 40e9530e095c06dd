"""Block checkpoints on the local filesystem.

Counterpart of the local-disk part of ``nums_tpu/core/io/filesystem.py``
(lines 36-247 and 280-385, 541-790 there), in one process. An array on
disk is a directory with one ``.npy`` file per grid block
(``block_<i>_<j>.npy``) and ``meta.pkl`` = ``{"grid": grid.to_meta(),
"checksums": {file name: crc32}}``, byte for byte the format that
``nums_tpu`` writes, so a checkpoint moves between the two packages.

A write is crash-consistent: blocks land in a ``.tmp-<pid>`` directory,
``meta.pkl`` is written last, files and directories are fsynced, and the
directory is published by rename, an earlier version kept as an
``.old-<pid>`` backup until the new one is in place. Readers promote a
complete orphan when a crash fell between the two renames. ``replicas``
> 1 writes full copies beside the primary (or under
``settings.replica_roots``); reads fail over to them block by block,
guarded by the CRCs, and ``verify_fs(repair=True)`` heals a bad copy
from an intact one.

The multi-process writers, S3, CSV and ``loadtxt``, and the native block
engine (``shard_io.cpp``) are later ports; here every block goes through
``np.save``/``np.load``.
"""

import os
import pickle
import re
import shutil
import zlib

import numpy as np

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.grid import ArrayGrid
from nums_tpu_torch.core.array.blockarray import BlockArray


def _fs_path(filename: str) -> str:
    if os.path.isabs(filename):
        return filename
    return os.path.join(settings.data_dir, filename)


def _block_fname(grid_entry: tuple) -> str:
    return "block_" + "_".join(map(str, grid_entry)) + ".npy"


def _block_crc(block: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(block).tobytes())


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
    has shape (1,), as nums_tpu's block writer stores it."""
    return np.ascontiguousarray(
        data[grid.get_slice(grid_entry)].cpu().numpy())


def _place(out, dst, blk):
    """out[dst] = blk, where a 0-d ``out`` takes its (1,) block."""
    out[dst] = blk.reshape(()) if out.ndim == 0 else blk


class FileSystem:
    """Block I/O of one process on the local filesystem."""

    def __init__(self, backend):
        self.backend = backend

    def write_fs(self, ba: BlockArray, filename: str, replicas: int = None):
        """Crash-consistent, optionally replicated write of ``ba``: one
        block at a time leaves the device, so host memory holds one
        block. Returns one True per block."""
        if replicas is None:
            replicas = settings.checkpoint_replicas
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
        for e in entries:
            blk = _host_block(data, ba.grid, e)
            fname = _block_fname(e)
            checksums[fname] = _block_crc(blk)
            for t in tmps:
                np.save(os.path.join(t, fname), blk)
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
        once, with the stored block shape. A primary block that is
        missing or does not load fails over to the replicas (always
        CRC-guarded); ``verify=True`` CRC-checks the primaries too."""
        path = _fs_path(filename)
        meta = self.read_meta_fs(filename)
        alt_dirs = _existing_replicas(path)
        checks = meta.get("checksums")
        grid = ArrayGrid.from_meta(meta["grid"])
        out = np.zeros(grid.shape, dtype=np.dtype(grid.dtype))
        for entry in grid.get_entry_iterator():
            p = os.path.join(path, _block_fname(entry))
            dst = grid.get_slice(entry)
            if not verify:
                try:
                    _place(out, dst, np.load(p))
                    continue
                except Exception:
                    pass  # fail over to the replicas
            _place(out, dst, self._load_block_checked(p, alt_dirs, checks))
        return BlockArray.from_np(out, block_shape=grid.block_shape,
                                  backend=self.backend)

    def delete_fs(self, filename: str):
        """Delete the checkpoint, its replicas and its publish orphans (an
        orphan left behind would bring the checkpoint back on the next
        read). Returns ``[existed]``."""
        path = _fs_path(filename)
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
        """
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
