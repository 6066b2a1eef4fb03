"""Content-addressed payload stores, Web3/IPFS and Theta — counterpart of
``fedml_tpu/core/distributed/communication/decentralized_storage.py`` (the
reference's ``web3_storage.py`` and ``theta_storage.py``).

- Both speak a plain HTTP contract through stdlib ``urllib``: web3 ``POST
  {upload_uri}`` returns JSON with a CID and ``GET
  {download_uri}/ipfs/{cid}`` fetches it; Theta wraps ``edgestore.PutData``
  and ``GetData`` in JSON-RPC with the bytes inline as hex.
- ``put_object`` returns the CID and the transport ships that CID: the
  caller's key is advisory. :class:`LocalCASObjectStore` is the offline
  twin (CID = sha256 of the stored bytes, blobs in a directory).
- With a secret (the reference's ``ipfs_secret_key``) each blob is sealed
  before upload: encrypt-then-MAC with an HMAC-SHA256 counter-mode
  keystream under a random nonce (:func:`seal`, :func:`unseal`), byte for
  byte the JAX package's format, so either package opens the other's blobs.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Optional

from fedml_tpu_torch.core.distributed.communication.object_store import (
    ObjectStore,
    atomic_write,
)

_NONCE = 16
_TAG = 32


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    blocks = (n + 31) // 32
    return b"".join(hmac.new(key, nonce + c.to_bytes(8, "big"), hashlib.sha256).digest()
                    for c in range(blocks))[:n]


def _xor(a: bytes, b: bytes) -> bytes:
    # one bigint XOR: a constant number of Python operations at any size
    return (int.from_bytes(a, "little") ^ int.from_bytes(b, "little")).to_bytes(
        len(a), "little")


def _derive(secret: bytes, label: bytes) -> bytes:
    return hmac.new(secret, label, hashlib.sha256).digest()


def seal(secret: bytes, plaintext: bytes) -> bytes:
    """Encrypt-then-MAC: ``nonce ‖ ciphertext ‖ HMAC tag``."""
    nonce = secrets.token_bytes(_NONCE)
    enc_key = _derive(secret, b"fedml-tpu-storage-enc")
    mac_key = _derive(secret, b"fedml-tpu-storage-mac")
    ct = _xor(plaintext, _keystream(enc_key, nonce, len(plaintext)))
    return nonce + ct + hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()


def unseal(secret: bytes, blob: bytes) -> bytes:
    """Open a sealed blob; a short, tampered or foreign-keyed one raises
    ``ValueError``."""
    if len(blob) < _NONCE + _TAG:
        raise ValueError("sealed blob too short")
    nonce, ct, tag = blob[:_NONCE], blob[_NONCE:-_TAG], blob[-_TAG:]
    enc_key = _derive(secret, b"fedml-tpu-storage-enc")
    mac_key = _derive(secret, b"fedml-tpu-storage-mac")
    if not hmac.compare_digest(tag, hmac.new(mac_key, nonce + ct, hashlib.sha256).digest()):
        raise ValueError("sealed blob failed authentication")
    return _xor(ct, _keystream(enc_key, nonce, len(ct)))


class _CASBase(ObjectStore):
    """Seal, upload and return the CID; download and unseal. Subclasses
    move the bytes."""

    content_addressed = True

    def __init__(self, secret_key: Optional[str] = None):
        self._secret = secret_key.encode("utf-8") if secret_key else None

    def _upload(self, data: bytes) -> str:
        raise NotImplementedError

    def _download(self, cid: str) -> bytes:
        raise NotImplementedError

    def _unpin(self, cid: str) -> None:
        """Pinning services delete at best effort; the default keeps."""

    def put_object(self, key: str, data: bytes) -> str:
        if self._secret is not None:
            data = seal(self._secret, data)
        return self._upload(data)  # the CID, not the advisory key

    def get_object(self, key: str) -> bytes:
        data = self._download(key)
        return unseal(self._secret, data) if self._secret is not None else data

    def delete_object(self, key: str) -> None:
        self._unpin(key)


def _http(method: str, url: str, data: Optional[bytes] = None, timeout: float = 30.0,
          headers: Optional[dict] = None) -> bytes:
    req = urllib.request.Request(url, data=data, method=method, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except urllib.error.HTTPError as e:
        if e.code == 404:
            raise KeyError(url) from e
        raise IOError(f"{method} {url}: HTTP {e.code} {e.reason}") from e


class Web3ObjectStore(_CASBase):
    """web3.storage's shape: ``POST`` upload → ``{"cid": ...}``, ``GET``
    gateway ``/ipfs/{cid}``; the bearer token from ``WEB3_STORAGE_TOKEN``
    unless given."""

    def __init__(self, upload_uri: str, download_uri: str, api_token: Optional[str] = None,
                 secret_key: Optional[str] = None, timeout: float = 30.0):
        super().__init__(secret_key)
        self.upload_uri = upload_uri
        self.download_uri = download_uri.rstrip("/")
        self.api_token = api_token or os.environ.get("WEB3_STORAGE_TOKEN")
        self.timeout = timeout

    def _upload(self, data: bytes) -> str:
        headers = {"Authorization": f"Bearer {self.api_token}"} if self.api_token else None
        body = json.loads(_http("POST", self.upload_uri, data, self.timeout,
                                headers).decode("utf-8"))
        cid = body.get("cid")
        if not cid:
            raise IOError(f"web3 upload returned no cid: {body!r}")
        return cid

    def _download(self, cid: str) -> bytes:
        return _http("GET", f"{self.download_uri}/ipfs/{urllib.parse.quote(cid)}",
                     timeout=self.timeout)


class ThetaObjectStore(_CASBase):
    """Theta EdgeStore's JSON-RPC (``edgestore.PutData`` / ``GetData``) on
    a local daemon, the bytes inline as hex."""

    def __init__(self, rpc_uri: str, secret_key: Optional[str] = None,
                 timeout: float = 30.0):
        super().__init__(secret_key)
        self.rpc_uri = rpc_uri
        self.timeout = timeout
        self._rpc_id = 0

    def _rpc(self, rpc_method: str, params: Any) -> Any:
        self._rpc_id += 1
        envelope = {"jsonrpc": "2.0", "id": self._rpc_id, "method": rpc_method,
                    "params": params}
        reply = json.loads(_http("POST", self.rpc_uri, json.dumps(envelope).encode("utf-8"),
                                 timeout=self.timeout).decode("utf-8"))
        if reply.get("error"):
            raise IOError(f"theta rpc {rpc_method}: {reply['error']}")
        return reply.get("result")

    def _upload(self, data: bytes) -> str:
        cid = (self._rpc("edgestore.PutData", [{"val": data.hex()}]) or {}).get("key")
        if not cid:
            raise IOError("theta PutData returned no key")
        return cid

    def _download(self, cid: str) -> bytes:
        val = (self._rpc("edgestore.GetData", [{"key": cid}]) or {}).get("val")
        if val is None:
            raise KeyError(cid)
        return bytes.fromhex(val)


class LocalCASObjectStore(_CASBase):
    """Content-addressed directory (``remote_storage: cas``): the CID is the
    sha256 hex of the stored bytes, and identical content is one blob."""

    def __init__(self, root: Optional[str] = None, secret_key: Optional[str] = None):
        super().__init__(secret_key)
        self.root = os.path.abspath(
            root or os.path.join(tempfile.gettempdir(), "fedml_tpu_cas"))
        os.makedirs(self.root, exist_ok=True)

    def _path(self, cid: str) -> str:
        if len(cid) != 64 or not all(c in "0123456789abcdef" for c in cid):
            raise ValueError(f"not a CID: {cid!r}")
        return os.path.join(self.root, cid)

    def _upload(self, data: bytes) -> str:
        cid = hashlib.sha256(data).hexdigest()
        path = self._path(cid)
        if not os.path.exists(path):
            atomic_write(path, data)
        return cid

    def _download(self, cid: str) -> bytes:
        try:
            with open(self._path(cid), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(cid) from None

    def _unpin(self, cid: str) -> None:
        try:
            os.unlink(self._path(cid))
        except (FileNotFoundError, ValueError):
            pass
