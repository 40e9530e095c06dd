"""In-process fake S3 client.

Counterpart of ``nums_tpu/core/io/fake_s3.py``. boto3 is optional; where
it is missing, or a test must never reach a real store, these clients
stand in with the call surface ``FileSystem`` uses (put_object,
get_object, delete_objects, create_bucket, list_objects_v2): one backed
by a dict shared by the process, one by a directory that several
processes share. They are enabled by ``NUMS_TPU_TORCH_FAKE_S3=1``,
``NUMS_TPU_TORCH_FAKE_S3_DIR`` or ``FileSystem.s3_client_factory``, never
taken silently in place of real S3.
"""

import os
import shutil
import threading
from urllib.parse import quote, unquote


class NoSuchKey(Exception):
    pass


class NoSuchBucket(Exception):
    pass


class _Body:
    def __init__(self, data: bytes):
        self._data = data

    def read(self):
        return self._data


class FakeS3Client:
    """Minimal boto3-client-compatible S3 stub over a shared dict store."""

    # One global store: all clients in the process see the same "cloud",
    # matching how separate boto3 clients see one region.
    _store = {}
    _lock = threading.Lock()

    # boto3 surfaces client exceptions as attributes.
    class exceptions:
        NoSuchKey = NoSuchKey
        NoSuchBucket = NoSuchBucket

    def create_bucket(self, Bucket):
        with self._lock:
            self._store.setdefault(Bucket, {})
        return {"Location": f"/{Bucket}"}

    def _bucket(self, name):
        # Auto-create on write paths for test ergonomics is NOT done:
        # missing buckets raise, like real S3.
        try:
            return self._store[name]
        except KeyError:
            raise NoSuchBucket(name)

    def put_object(self, Bucket, Key, Body):
        if isinstance(Body, str):
            Body = Body.encode()
        with self._lock:
            self._bucket(Bucket)[Key] = bytes(Body)
        return {"ETag": str(hash(Body))}

    def get_object(self, Bucket, Key):
        with self._lock:
            bucket = self._bucket(Bucket)
            try:
                data = bucket[Key]
            except KeyError:
                raise NoSuchKey(Key)
        return {"Body": _Body(data)}

    def delete_object(self, Bucket, Key):
        with self._lock:
            self._bucket(Bucket).pop(Key, None)
        return {}

    def delete_objects(self, Bucket, Delete):
        with self._lock:
            bucket = self._bucket(Bucket)
            deleted = []
            for obj in Delete.get("Objects", []):
                if bucket.pop(obj["Key"], None) is not None:
                    deleted.append({"Key": obj["Key"]})
        return {"Deleted": deleted}

    def list_objects_v2(self, Bucket, Prefix=""):
        with self._lock:
            keys = sorted(
                k for k in self._bucket(Bucket) if k.startswith(Prefix)
            )
        return {
            "KeyCount": len(keys),
            "Contents": [{"Key": k} for k in keys],
        }

    @classmethod
    def reset(cls):
        with cls._lock:
            cls._store.clear()


class FileBackedFakeS3Client(FakeS3Client):
    """Fake S3 kept under a directory (``NUMS_TPU_TORCH_FAKE_S3_DIR``).

    Objects are files at ``<root>/<bucket>/<quoted-key>``, so separate
    processes that share the directory see one store (the in-memory fake
    is local to its process), and so do the two packages: nums_tpu's
    file-backed fake keeps the same layout. Keys are URL-quoted; a put is
    atomic per object (tmp + rename), as S3's is per key.
    """

    def __init__(self, root: str):
        self._root = root
        os.makedirs(root, exist_ok=True)

    def _bpath(self, bucket):
        p = os.path.join(self._root, bucket)
        if not os.path.isdir(p):
            raise NoSuchBucket(bucket)
        return p

    def _kpath(self, bucket, key):
        return os.path.join(self._bpath(bucket), quote(key, safe=""))

    def create_bucket(self, Bucket):
        os.makedirs(os.path.join(self._root, Bucket), exist_ok=True)
        return {"Location": f"/{Bucket}"}

    def put_object(self, Bucket, Key, Body):
        if isinstance(Body, str):
            Body = Body.encode()
        path = self._kpath(Bucket, Key)
        # Temp names start with '#', which quote(key) can never produce
        # (real keys quote '#' to %23) — in-flight/orphaned temps are
        # thus invisible to listings, preserving per-key atomicity.
        tmp = os.path.join(
            os.path.dirname(path),
            f"#tmp-{os.getpid()}-{os.path.basename(path)}",
        )
        with open(tmp, "wb") as f:
            f.write(bytes(Body))
        os.replace(tmp, path)
        return {"ETag": str(hash(bytes(Body)))}

    def get_object(self, Bucket, Key):
        try:
            with open(self._kpath(Bucket, Key), "rb") as f:
                return {"Body": _Body(f.read())}
        except FileNotFoundError:
            raise NoSuchKey(Key)

    def delete_object(self, Bucket, Key):
        try:
            os.remove(self._kpath(Bucket, Key))
        except FileNotFoundError:
            pass
        return {}

    def delete_objects(self, Bucket, Delete):
        deleted = []
        for obj in Delete.get("Objects", []):
            try:
                os.remove(self._kpath(Bucket, obj["Key"]))
                deleted.append({"Key": obj["Key"]})
            except FileNotFoundError:
                pass
        return {"Deleted": deleted}

    def list_objects_v2(self, Bucket, Prefix=""):
        keys = sorted(
            unquote(f) for f in os.listdir(self._bpath(Bucket))
            if not f.startswith("#") and unquote(f).startswith(Prefix)
        )
        return {
            "KeyCount": len(keys),
            "Contents": [{"Key": k} for k in keys],
        }

    def reset(self):  # instance-level: clears THIS root's objects
        for entry in os.listdir(self._root):
            shutil.rmtree(os.path.join(self._root, entry),
                          ignore_errors=True)
