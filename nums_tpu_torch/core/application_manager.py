"""Process-global application lifecycle.

Counterpart of ``nums_tpu/core/application_manager.py`` without the init
watchdog: a lazy singleton that builds the backend and the
``ArrayApplication`` from ``settings``. A process that is one of several
in a ``torch.distributed`` group (``core/multiprocess.py``) runs the mesh
backend whatever ``settings.backend_name`` says, with a logged warning.
"""

import logging

from nums_tpu_torch.core import multiprocess, settings
from nums_tpu_torch.core.backend import make_backend
from nums_tpu_torch.core.array.application import ArrayApplication
from nums_tpu_torch.core.io.filesystem import FileSystem

_instance: ArrayApplication = None


def is_initialized() -> bool:
    return _instance is not None


def instance() -> ArrayApplication:
    global _instance
    if _instance is None:
        _instance = create()
    return _instance


def set_instance(app: ArrayApplication):
    global _instance
    _instance = app


def create(device=None, backend=None, cluster_shape=None) -> ArrayApplication:
    """A new application on ``device`` (default ``cuda:0``, on the mesh
    ``cuda:<local rank>``; raises ``RuntimeError`` where CUDA is missing,
    and ``device="cpu"`` asks for the CPU). ``backend`` defaults to
    ``settings.backend_name``; ``cluster_shape`` is the mesh's shape."""
    settings.configure_precision()
    name = backend or settings.backend_name
    kwargs = {"device": device}
    if name != "mesh":
        joined = multiprocess.initialize(
            multiprocess.device_for(device).type)
        if joined and multiprocess.is_multiprocess():
            logging.getLogger(__name__).warning(
                "multi-process torch.distributed group detected: forcing "
                "the mesh backend (backend %r cannot address the other "
                "processes' shards)", name)
            name = "mesh"
    if name == "mesh":
        kwargs["cluster_shape"] = cluster_shape
    backend = make_backend(name, **kwargs)
    return ArrayApplication(backend, FileSystem(backend))


def destroy():
    global _instance
    if _instance is None:
        return
    _instance.backend.shutdown()
    _instance = None
