"""S3-protocol object store, AWS Signature V4 over stdlib HTTP — counterpart
of ``fedml_tpu/core/distributed/communication/s3_store.py`` (the
reference's boto3 wrapper, ``s3/remote_storage.py``).

Path-style ``PUT/GET/DELETE {endpoint}/{bucket}/{key}`` with SigV4
``Authorization`` headers, so it speaks to AWS S3 or any S3-compatible
endpoint (MinIO, GCS interop) with no third-party package. Credentials come
only from the environment (``AWS_ACCESS_KEY_ID``,
``AWS_SECRET_ACCESS_KEY``), never from a config file. Each request's wall
(signing included) lands in the ``store/s3_ms`` histogram, labelled by
method.
"""
from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Any, Dict, Optional

from fedml_tpu_torch.core.distributed.communication.object_store import ObjectStore
from fedml_tpu_torch.telemetry import get_registry

_ALGO = "AWS4-HMAC-SHA256"


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode("utf-8"), hashlib.sha256).digest()


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sigv4_headers(method: str, url: str, payload: bytes, access_key: str,
                  secret_key: str, region: str, service: str = "s3",
                  now: Optional[datetime.datetime] = None) -> Dict[str, str]:
    """The SigV4 ``Authorization`` and ``x-amz-*`` headers of a request: a
    pure function of the request, the credentials and the clock."""
    parsed = urllib.parse.urlsplit(url)
    # S3 signs the on-the-wire (already encoded) path verbatim: no
    # normalization, no double encoding
    canonical_uri = parsed.path or "/"
    canonical_query = ""
    if parsed.query:
        pairs = sorted(urllib.parse.parse_qsl(parsed.query, keep_blank_values=True))
        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='-_.~')}={urllib.parse.quote(v, safe='-_.~')}"
            for k, v in pairs)
    t = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = t.strftime("%Y%m%dT%H%M%SZ")
    datestamp = t.strftime("%Y%m%d")
    payload_hash = _sha256_hex(payload)
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_headers = (f"host:{parsed.netloc}\n"
                         f"x-amz-content-sha256:{payload_hash}\n"
                         f"x-amz-date:{amz_date}\n")
    canonical_request = "\n".join([method, canonical_uri, canonical_query,
                                   canonical_headers, signed_headers, payload_hash])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(
        [_ALGO, amz_date, scope, _sha256_hex(canonical_request.encode("utf-8"))])
    key = ("AWS4" + secret_key).encode("utf-8")
    for part in (datestamp, region, service, "aws4_request"):
        key = _hmac(key, part)
    signature = hmac.new(key, string_to_sign.encode("utf-8"), hashlib.sha256).hexdigest()
    return {
        "x-amz-date": amz_date,
        "x-amz-content-sha256": payload_hash,
        "Authorization": (f"{_ALGO} Credential={access_key}/{scope}, "
                          f"SignedHeaders={signed_headers}, Signature={signature}"),
    }


class S3ObjectStore(ObjectStore):
    """Path-style S3 client: ``{endpoint}/{bucket}/{key}``."""

    def __init__(self, endpoint: str, bucket: str, region: str = "us-east-1",
                 access_key: Optional[str] = None, secret_key: Optional[str] = None,
                 timeout: float = 30.0):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket
        self.region = region
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.timeout = timeout
        reg = get_registry()
        self._m_ms = {m: reg.histogram("store/s3_ms", labels={"method": m})
                      for m in ("PUT", "GET", "DELETE")}

    @classmethod
    def from_args(cls, args: Any) -> "S3ObjectStore":
        """``s3_endpoint``, ``s3_bucket`` and ``s3_region`` from the config;
        the credentials from the environment."""
        return cls(endpoint=getattr(args, "s3_endpoint", "https://s3.amazonaws.com"),
                   bucket=getattr(args, "s3_bucket", "fedml-tpu"),
                   region=getattr(args, "s3_region", "us-east-1"))

    def _url(self, key: str) -> str:
        # keys arrive off the wire: no absolute path, no traversal
        if key.startswith("/") or ".." in key.split("/"):
            raise ValueError(f"invalid object key: {key!r}")
        return f"{self.endpoint}/{self.bucket}/{urllib.parse.quote(key, safe='/-_.~')}"

    def _request(self, method: str, key: str, payload: bytes = b"") -> bytes:
        t0 = time.perf_counter()
        url = self._url(key)
        headers = sigv4_headers(method, url, payload, self.access_key, self.secret_key,
                                self.region)
        req = urllib.request.Request(url, data=payload or None, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise KeyError(key) from e
            raise IOError(f"S3 {method} {key}: HTTP {e.code} {e.reason}") from e
        self._m_ms[method].observe((time.perf_counter() - t0) * 1e3)
        return body

    def put_object(self, key: str, data: bytes) -> str:
        self._request("PUT", key, data)
        return key

    def get_object(self, key: str) -> bytes:
        return self._request("GET", key)

    def delete_object(self, key: str) -> None:
        try:
            self._request("DELETE", key)
        except KeyError:
            pass
