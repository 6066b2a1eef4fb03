"""Object store — counterpart of
``fedml_tpu/core/distributed/communication/object_store.py``: the payload
offload seam of the BROKER transport (the reference's S3).

:func:`create_object_store` dispatches ``remote_storage`` as the reference
does: ``local`` (the default) is a shared directory with atomic writes;
``s3`` the S3 REST protocol with SigV4 (``s3_store``); ``web3``/``ipfs`` and
``theta`` the content-addressed decentralized stores and ``cas`` their
offline twin, a directory keyed by the sha256 of the bytes, so a broadcast
fanned out to N receivers is one blob (``decentralized_storage``). The
content-addressed stores seal their blobs under ``ipfs_secret_key``. Blobs
and seals are byte-compatible with the reference's.
"""
from __future__ import annotations

import abc
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


def atomic_write(path: str, data: bytes) -> None:
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
        atomic_write(self._path(key), data)
        return key

    def get_object(self, key: str) -> bytes:
        with open(self._path(key), "rb") as f:
            return f.read()

    def delete_object(self, key: str) -> None:
        try:
            os.unlink(self._path(key))
        except FileNotFoundError:
            pass


def create_object_store(args: Any = None) -> ObjectStore:
    """The store ``args.remote_storage`` names (the reference's dispatch);
    an unknown name raises ``ValueError``."""
    kind = (getattr(args, "remote_storage", None) or "local").lower()
    secret = getattr(args, "ipfs_secret_key", None)
    if kind == "s3":
        from fedml_tpu_torch.core.distributed.communication.s3_store import S3ObjectStore

        return S3ObjectStore.from_args(args)
    if kind in ("web3", "ipfs", "theta", "cas"):
        from fedml_tpu_torch.core.distributed.communication import (
            decentralized_storage as ds,
        )

        if kind == "theta":
            return ds.ThetaObjectStore(
                rpc_uri=getattr(args, "theta_rpc_uri", "http://localhost:19888/rpc"),
                secret_key=secret)
        if kind == "cas":
            return ds.LocalCASObjectStore(getattr(args, "object_store_dir", None),
                                          secret_key=secret)
        return ds.Web3ObjectStore(
            upload_uri=getattr(args, "web3_upload_uri", "https://api.web3.storage/upload"),
            download_uri=getattr(args, "web3_download_uri", "https://w3s.link"),
            secret_key=secret)
    if kind != "local":
        raise ValueError(f"unknown remote_storage {kind!r}")
    return LocalDirObjectStore(getattr(args, "object_store_dir", None))
