"""Top-level I/O verbs (``nums_tpu/api.py:1-27``): ``read``, ``write`` and
``delete`` of a block checkpoint through the active application's
``FileSystem``. An ``s3://`` name raises ``NotImplementedError`` until S3
is ported; CSV and Parquet are later ports too."""

from nums_tpu_torch.core.application_manager import instance as _instance


def _local(filename: str) -> str:
    if filename.startswith("s3://"):
        raise NotImplementedError(
            f"{filename!r}: S3 storage is not ported yet; use a local path"
        )
    return filename


def read(filename: str):
    """Read a persisted BlockArray."""
    return _instance().read_fs(_local(filename))


def write(ba, filename: str):
    return _instance().write_fs(ba, _local(filename))


def delete(filename: str):
    return _instance().delete_fs(_local(filename))
