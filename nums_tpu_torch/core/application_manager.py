"""Process-global application lifecycle.

Counterpart of ``nums_tpu/core/application_manager.py`` without the
multi-process runtime and the init watchdog: a lazy singleton that builds
the backend and the ``ArrayApplication`` from ``settings``.
"""

from nums_tpu_torch.core import settings
from nums_tpu_torch.core.backend import make_backend
from nums_tpu_torch.core.array.application import ArrayApplication

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


def create(device=None) -> ArrayApplication:
    """A new application on ``device`` (default ``cuda:0``; raises
    ``RuntimeError`` where CUDA is missing, and ``device="cpu"`` asks for
    the CPU)."""
    settings.configure_precision()
    return ArrayApplication(make_backend(settings.backend_name,
                                         device=device))


def destroy():
    global _instance
    if _instance is None:
        return
    _instance.backend.shutdown()
    _instance = None
