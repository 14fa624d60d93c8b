"""S3-compatible object storage access: a copy of
myscaledb_tpu/runtime/object_storage.py (it imports nothing of either
package).

Reference analog: src/Storages/StorageS3.cpp + src/IO/S3/ (the reference
links aws-sdk-cpp; PocoHTTPClient does the transport and the SDK signs).
Here the client is native: urllib transport + a hand-rolled AWS Signature
Version 4 signer (pure hashlib/hmac — verified against the published AWS
test vectors in tests/test_object_storage.py).  Works against real S3 and
any S3-compatible endpoint (minio, localstack, a plain HTTP server for
anonymous GETs).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
import urllib.request


def _sha256(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_headers(method: str, url: str, access_key: str, secret_key: str,
                  region: str = "us-east-1", service: str = "s3",
                  payload: bytes = b"", now: datetime.datetime | None = None,
                  extra_headers: dict | None = None) -> dict:
    """AWS SigV4 Authorization + x-amz-* headers for one request
    (https://docs.aws.amazon.com/IAM/latest/UserGuide/create-signed-request.html).
    ``now`` is injectable for the deterministic test vectors."""
    u = urllib.parse.urlsplit(url)
    host = u.netloc
    if now is None:
        now = datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    payload_hash = _sha256(payload)

    canonical_uri = urllib.parse.quote(u.path or "/", safe="/-_.~")
    # canonical query: sorted, each key/value URI-encoded
    q = urllib.parse.parse_qsl(u.query, keep_blank_values=True)
    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='-_.~')}="
        f"{urllib.parse.quote(v, safe='-_.~')}"
        for k, v in sorted(q))
    headers = {"host": host, "x-amz-content-sha256": payload_hash,
               "x-amz-date": amz_date}
    for k, v in (extra_headers or {}).items():
        headers[k.lower()] = v.strip()
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n"
                                for k in sorted(headers))
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_hash])

    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                                _sha256(canonical_request.encode())])
    k = _hmac(("AWS4" + secret_key).encode(), datestamp)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(),
                         hashlib.sha256).hexdigest()
    auth = (f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}")
    out = {"Authorization": auth, "x-amz-date": amz_date,
           "x-amz-content-sha256": payload_hash}
    return out


def s3_get(url: str, access_key: str = "", secret_key: str = "",
           region: str = "us-east-1", timeout: float = 30.0) -> bytes:
    """GET an object; signed when credentials are given, anonymous
    otherwise (public buckets / any plain HTTP endpoint)."""
    req = urllib.request.Request(url)
    if access_key:
        for k, v in sigv4_headers("GET", url, access_key, secret_key,
                                  region).items():
            req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()
