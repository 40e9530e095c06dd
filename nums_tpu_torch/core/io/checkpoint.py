"""Versioned checkpoints with a restore that tolerates corruption.

Counterpart of ``nums_tpu/core/io/checkpoint.py``, in one process, on
``FileSystem.write_fs``'s crash-consistent publish:

- ``save(ba, name, step)`` writes ``<name>/step_<step>`` and prunes to the
  ``keep`` newest steps; ``replicas=k`` writes k full copies of each step
  (per-block failover and CRC scrub, ``FileSystem.verify_fs``).
- ``save_async`` runs ``save`` on one background worker, so saves publish
  in order; ``wait_pending`` waits for them.
- ``restore_latest(name)`` returns the newest step that loads, falling
  back to older ones past a torn or corrupt step; ``verify=True``
  CRC-checks every block.
- ``resume_step(name)`` is where a training loop restarts.
- ``journal(name)`` is the append-only event log (begin, commit, prune,
  restore, with wall-clock timestamps).
"""

import os
import re
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.application_manager import instance
from nums_tpu_torch.core.io.filesystem import _recover_fs_dir


def _journal_append(root: str, event: str, step):
    try:
        os.makedirs(root, exist_ok=True)
        with open(os.path.join(root, "journal.log"), "a") as f:
            f.write(f"{time.time():.3f} {event} {step}\n")
    except OSError:  # journaling never fails the job
        pass


def journal(name: str):
    """[(timestamp, event, step)] of the checkpoint's event log."""
    p = os.path.join(_root(name), "journal.log")
    if not os.path.isfile(p):
        return []
    out = []
    with open(p) as f:
        for line in f:
            # An append is not atomic: a crash mid-append leaves a torn
            # last line, and the readable prefix is the journal.
            try:
                ts, event, step = line.split()
                out.append((float(ts), event, int(step)))
            except ValueError:
                continue
    return out


_STEP_RE = re.compile(r"^step_(\d+)$")
_ORPHAN_STEP_RE = re.compile(r"^step_(\d+)\.(?:tmp|old)-\d+$")


def _root(name: str) -> str:
    if os.path.isabs(name):
        return name
    return os.path.join(settings.data_dir, name)


def steps(name: str):
    """Sorted step numbers of the complete checkpoints. A step torn
    mid-publish is promoted from its complete orphan, not dropped."""
    root = _root(name)
    if not os.path.isdir(root):
        return []
    nums = set()
    for entry in os.listdir(root):
        m = _STEP_RE.match(entry) or _ORPHAN_STEP_RE.match(entry)
        if m:
            nums.add(int(m.group(1)))
    return [
        n for n in sorted(nums)
        if _recover_fs_dir(os.path.join(root, f"step_{n}"))
    ]


def save(ba, name: str, step: int, keep: int = 2, replicas: int = None):
    """Write ``<name>/step_<step>`` atomically; prune to ``keep`` newest."""
    fs = instance().fs
    root = _root(name)
    os.makedirs(root, exist_ok=True)
    _journal_append(root, "begin", step)
    fs.write_fs(ba, os.path.join(root, f"step_{step}"), replicas=replicas)
    _journal_append(root, "commit", step)
    if keep is not None and keep > 0:
        for old in steps(name)[:-keep]:
            fs.delete_fs(os.path.join(root, f"step_{old}"))
            _journal_append(root, "prune", old)
    return step


_async_executor = None


def save_async(ba, name: str, step: int, keep: int = 2,
               replicas: int = None):
    """``save`` on a background worker: the device-to-host copies and the
    disk writes run while the caller goes on. A BlockArray is immutable,
    so the save is of its value at the call. Returns a Future whose
    ``result()`` is the step, or raises the write's error. One worker, so
    saves publish in order."""
    global _async_executor
    from nums_tpu_torch.core import multiprocess

    ba.touch()
    if multiprocess.is_multiprocess():
        # The write is collective: on a background thread its barriers
        # could interleave with the caller's collectives and deadlock.
        # Under several processes the save runs here, and the Future is
        # already done.
        from concurrent.futures import Future

        fut = Future()
        try:
            fut.set_result(save(ba, name, step, keep, replicas))
        except Exception as e:  # an interrupt still propagates
            fut.set_exception(e)
        return fut
    if _async_executor is None:
        _async_executor = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="ckpt-save")
    return _async_executor.submit(save, ba, name, step, keep, replicas)


def wait_pending():
    """Block until every ``save_async`` so far has published."""
    global _async_executor
    if _async_executor is not None:
        _async_executor.shutdown(wait=True)
        _async_executor = None


def restore_latest(name: str, verify: bool = False):
    """(step, BlockArray) of the newest checkpoint that loads. A torn or
    corrupt step (missing blocks, a bad pickle) gives way to the one
    before it, after its replicas; ``verify=True`` CRC-checks every block.
    Raises FileNotFoundError when none loads."""
    fs = instance().fs
    root = _root(name)
    for step in reversed(steps(name)):
        try:
            ba = fs.read_fs(os.path.join(root, f"step_{step}"),
                            verify=verify)
        except Exception:  # a torn checkpoint: try the one before
            continue
        _journal_append(root, "restore", step)
        return step, ba
    raise FileNotFoundError(f"no restorable checkpoint under {root}")


def resume_step(name: str, default: int = 0) -> int:
    """The step after the newest complete checkpoint."""
    s = steps(name)
    return (s[-1] + 1) if s else default


def delete(name: str):
    shutil.rmtree(_root(name), ignore_errors=True)
