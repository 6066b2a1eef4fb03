"""Object store — counterpart of
``fedml_tpu/core/distributed/communication/object_store.py``: the payload
offload seam of the BROKER transport (the reference's S3).

Two stores: a shared directory (``remote_storage: local``, the default)
with atomic writes, and its content-addressed twin (``remote_storage:
cas``: the key is the sha256 of the bytes, so a broadcast fanned out to N
receivers is one blob). Both are plain files, byte-compatible with the
reference's. S3, web3/IPFS, Theta and sealed (encrypted) blobs come with
ROADMAP A10.4; naming one raises.
"""
from __future__ import annotations

import abc
import hashlib
import os
import tempfile
import uuid
from typing import Any, Optional


class ObjectStore(abc.ABC):
    #: a content-addressed store dedups identical payloads under one key, so
    #: a receiver must never delete after fetch (the sender unpins instead)
    content_addressed = False

    @abc.abstractmethod
    def put_object(self, key: str, data: bytes) -> str:
        """Store bytes; returns the key to fetch them by."""

    @abc.abstractmethod
    def get_object(self, key: str) -> bytes:
        ...

    @abc.abstractmethod
    def delete_object(self, key: str) -> None:
        ...

    def new_key(self, prefix: str = "payload") -> str:
        return f"{prefix}/{uuid.uuid4().hex}"


def _atomic_write(path: str, data: bytes) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # readers never see a partial blob
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class LocalDirObjectStore(ObjectStore):
    """A shared directory, atomic writes (tmp + rename)."""

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(
            root or os.path.join(tempfile.gettempdir(), "fedml_tpu_store"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys arrive off the wire: reject anything that escapes the root
        if os.path.isabs(key) or os.path.splitdrive(key)[0]:
            raise ValueError(f"object key must be relative: {key!r}")
        path = os.path.realpath(os.path.join(self.root, key))
        root = os.path.realpath(self.root)
        if not (path == root or path.startswith(root + os.sep)):
            raise ValueError(f"object key escapes store root: {key!r}")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    def put_object(self, key: str, data: bytes) -> str:
        _atomic_write(self._path(key), data)
        return key

    def get_object(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def delete_object(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


class LocalCASObjectStore(ObjectStore):
    """Content-addressed directory: the key (CID) is the sha256 hex of the
    bytes, and identical content is one blob."""

    content_addressed = True

    def __init__(self, root: Optional[str] = None):
        self.root = os.path.abspath(
            root or os.path.join(tempfile.gettempdir(), "fedml_tpu_cas"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, cid: str) -> str:
        if len(cid) != 64 or not all(c in "0123456789abcdef" for c in cid):
            raise ValueError(f"not a CID: {cid!r}")
        return os.path.join(self.root, cid)

    def put_object(self, key: str, data: bytes) -> str:
        cid = hashlib.sha256(data).hexdigest()
        path = self._path(cid)
        if not os.path.exists(path):
            _atomic_write(path, data)
        return cid  # the CID, not the advisory key

    def get_object(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key) from None

    def delete_object(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except (FileNotFoundError, ValueError):
            pass


def create_object_store(args: Any = None) -> ObjectStore:
    """The store ``args.remote_storage`` names, rooted at
    ``args.object_store_dir``."""
    kind = (getattr(args, "remote_storage", None) or "local").lower()
    root = getattr(args, "object_store_dir", None) if args is not None else None
    if kind in ("s3", "web3", "ipfs", "theta"):
        raise NotImplementedError(
            f"remote_storage {kind!r} comes with ROADMAP A10.4; the port has the "
            "shared-directory stores 'local' and 'cas'")
    if getattr(args, "ipfs_secret_key", None):
        raise NotImplementedError(
            "ipfs_secret_key: sealed (encrypted) blobs come with ROADMAP A10.4")
    if kind == "cas":
        return LocalCASObjectStore(root)
    if kind != "local":
        raise ValueError(f"unknown remote_storage {kind!r}")
    return LocalDirObjectStore(root)
