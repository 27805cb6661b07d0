"""Storage providers for guest images / inputs.

The port's copy of `boundless_tpu/market/storage_providers.py`.

Re-design of `crates/boundless-market/src/storage/providers/` (S3, GCS,
Pinata/IPFS, HTTP, file, mock). Providers share the duck-type:
`upload(key, bytes) -> url` and `download(url) -> bytes`.

The cloud providers are real, SDK-free implementations over stdlib HTTP
(the reference uses aws-sdk / reqwest): S3 speaks AWS Signature V4
against any S3-compatible endpoint (AWS, MinIO, R2), GCS uses the JSON
upload API with a bearer token, Pinata does the multipart pinFileToIPFS
flow. Each takes an explicit `endpoint`, so the unit tests exercise the
full request path (signing, headers, body framing) against a local HTTP
server — this image has zero network egress, not zero HTTP.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import os
import tempfile
import urllib.parse
import urllib.request
import uuid
from typing import Dict, Optional


class MockStorageProvider:
    """In-memory provider (reference providers/mock.rs)."""

    def __init__(self):
        self._data: Dict[str, bytes] = {}

    def upload(self, key: str, data: bytes) -> str:
        url = f"mock://{key}"
        self._data[url] = data
        return url

    def download(self, url: str) -> bytes:
        return self._data[url]


class FileStorageProvider:
    """File-backed provider (reference providers/file.rs)."""

    def __init__(self, root: str = None):
        self.root = root or tempfile.mkdtemp(prefix="bt_storage_")

    def upload(self, key: str, data: bytes) -> str:
        assert ".." not in key
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)
        return f"file://{path}"

    def download(self, url: str) -> bytes:
        assert url.startswith("file://")
        with open(url[len("file://"):], "rb") as f:
            return f.read()


def _http(method: str, url: str, body: Optional[bytes] = None,
          headers: Optional[dict] = None, timeout: float = 60.0) -> bytes:
    req = urllib.request.Request(url, data=body, method=method,
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


class HttpStorageProvider:
    """Fetch-only provider for http(s) URLs (reference fetch_url)."""

    def upload(self, key: str, data: bytes) -> str:
        raise NotImplementedError("HTTP provider is download-only")

    def download(self, url: str) -> bytes:
        assert url.startswith(("http://", "https://"))
        return _http("GET", url)


# ---------------------------------------------------------------------------
# S3 (AWS Signature V4 over stdlib; reference providers/s3.rs)
# ---------------------------------------------------------------------------


def _sigv4_headers(method: str, url: str, region: str, access_key: str,
                   secret_key: str, payload: bytes,
                   now: Optional[datetime.datetime] = None) -> dict:
    """AWS SigV4 auth headers for one S3 request (service 's3')."""
    u = urllib.parse.urlparse(url)
    host = u.netloc
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = hashlib.sha256(payload or b"").hexdigest()

    # The wire path is already RFC3986-encoded exactly once by the URL
    # builder; for S3 the canonical URI is that path VERBATIM (re-quoting
    # would double-encode '%' and break the signature on any key that
    # needs encoding). Query params are URI-encoded per the SigV4 spec
    # and sorted by encoded key, then value.
    canonical_uri = u.path or "/"
    if u.query:
        enc = lambda s: urllib.parse.quote(urllib.parse.unquote(s),
                                           safe="-_.~")
        pairs = sorted(
            (enc(k), enc(v)) for k, _, v in
            (part.partition("=") for part in u.query.split("&") if part))
        canonical_query = "&".join(f"{k}={v}" for k, v in pairs)
    else:
        canonical_query = ""
    signed_headers = "host;x-amz-content-sha256;x-amz-date"
    canonical_headers = (f"host:{host}\n"
                         f"x-amz-content-sha256:{payload_hash}\n"
                         f"x-amz-date:{amz_date}\n")
    canonical_request = "\n".join([method, canonical_uri, canonical_query,
                                   canonical_headers, signed_headers,
                                   payload_hash])
    scope = f"{datestamp}/{region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])

    def _hm(key, msg):
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k = _hm(("AWS4" + secret_key).encode(), datestamp)
    k = _hm(k, region)
    k = _hm(k, "s3")
    k = _hm(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256)
    auth = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, "
            f"Signature={signature.hexdigest()}")
    return {"Authorization": auth, "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash}


class S3StorageProvider:
    """S3-compatible provider, SigV4-signed PUT/GET over stdlib HTTP
    (reference providers/s3.rs; works against AWS/MinIO/R2 endpoints)."""

    def __init__(self, bucket: str, endpoint: str = None,
                 region: str = None, access_key: str = None,
                 secret_key: str = None, url_style: str = "path"):
        self.bucket = bucket
        self.endpoint = (endpoint or os.environ.get("S3_ENDPOINT")
                         or "https://s3.amazonaws.com").rstrip("/")
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get(
            "AWS_SECRET_ACCESS_KEY", "")
        assert url_style in ("path", "virtual")
        self.url_style = url_style

    def _object_url(self, bucket: str, key: str) -> str:
        if self.url_style == "virtual":
            scheme, rest = self.endpoint.split("://", 1)
            return f"{scheme}://{bucket}.{rest}/{urllib.parse.quote(key)}"
        return f"{self.endpoint}/{bucket}/{urllib.parse.quote(key)}"

    def _signed(self, method: str, url: str, body: bytes = b"") -> bytes:
        headers = _sigv4_headers(method, url, self.region, self.access_key,
                                 self.secret_key, body)
        return _http(method, url, body or None, headers)

    def upload(self, key: str, data: bytes) -> str:
        self._signed("PUT", self._object_url(self.bucket, key), data)
        return f"s3://{self.bucket}/{key}"

    def download(self, url: str) -> bytes:
        assert url.startswith("s3://")
        bucket, _, key = url[len("s3://"):].partition("/")
        return self._signed("GET", self._object_url(bucket, key))


# ---------------------------------------------------------------------------
# GCS (JSON upload API; reference uses the same media-upload endpoint)
# ---------------------------------------------------------------------------


class GcsStorageProvider:
    """Google Cloud Storage via the JSON media-upload API with a bearer
    token (no SDK; token from metadata server / workload identity)."""

    def __init__(self, bucket: str, token: str = None, endpoint: str = None):
        self.bucket = bucket
        self.token = token or os.environ.get("GCS_TOKEN", "")
        self.endpoint = (endpoint
                         or "https://storage.googleapis.com").rstrip("/")

    def upload(self, key: str, data: bytes) -> str:
        q = urllib.parse.quote(key, safe="")
        url = (f"{self.endpoint}/upload/storage/v1/b/{self.bucket}/o"
               f"?uploadType=media&name={q}")
        _http("POST", url, data, {
            "Authorization": f"Bearer {self.token}",
            "Content-Type": "application/octet-stream"})
        return f"gs://{self.bucket}/{key}"

    def download(self, url: str) -> bytes:
        assert url.startswith("gs://")
        bucket, _, key = url[len("gs://"):].partition("/")
        q = urllib.parse.quote(key, safe="")
        return _http("GET",
                     f"{self.endpoint}/storage/v1/b/{bucket}/o/{q}?alt=media",
                     headers={"Authorization": f"Bearer {self.token}"})


# ---------------------------------------------------------------------------
# Pinata / IPFS (multipart pinFileToIPFS; reference providers/pinata.rs)
# ---------------------------------------------------------------------------


class PinataStorageProvider:
    """IPFS pinning via Pinata's pinFileToIPFS + gateway fetch."""

    def __init__(self, jwt: str = None, endpoint: str = None,
                 gateway: str = None):
        self.jwt = jwt or os.environ.get("PINATA_JWT", "")
        self.endpoint = (endpoint or "https://api.pinata.cloud").rstrip("/")
        self.gateway = (gateway or "https://gateway.pinata.cloud").rstrip("/")

    def upload(self, key: str, data: bytes) -> str:
        boundary = uuid.uuid4().hex
        body = (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; '
            f'filename="{key}"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + data + f"\r\n--{boundary}--\r\n".encode()
        resp = _http("POST", f"{self.endpoint}/pinning/pinFileToIPFS", body, {
            "Authorization": f"Bearer {self.jwt}",
            "Content-Type": f"multipart/form-data; boundary={boundary}"})
        cid = json.loads(resp)["IpfsHash"]
        return f"ipfs://{cid}"

    def download(self, url: str) -> bytes:
        assert url.startswith("ipfs://")
        return _http("GET", f"{self.gateway}/ipfs/{url[len('ipfs://'):]}")


def provider_for(url_or_scheme: str, **kwargs):
    """Scheme-dispatch factory (reference storage provider registry)."""
    s = url_or_scheme.split("://")[0]
    return {
        "mock": MockStorageProvider,
        "file": FileStorageProvider,
        "http": HttpStorageProvider,
        "https": HttpStorageProvider,
        "s3": S3StorageProvider,
        "gs": GcsStorageProvider,
        "ipfs": PinataStorageProvider,
    }[s](**kwargs)
