"""Column compression codecs: the port of myscaledb_tpu/storage/codecs.py
(host-side numpy; the same frames, checksums and codec ids, so a frame one
package writes the other reads, and a zlib or lz frame is byte-identical).
Reference: src/Compression/.

The reference ships LZ4/ZSTD/Delta/DoubleDelta/Gorilla/T64 block codecs.
On-disk parts here use stdlib-only equivalents (no pip installs allowed):

  none       raw bytes
  zlib       DEFLATE (the LZ4/ZSTD general-purpose slot)
  delta      per-element delta (int columns) then DEFLATE — the reference's
             Delta+LZ4 combo (CompressionCodecDelta.cpp)
  shuffle    byte-plane transpose then DEFLATE (floats/embeddings compress
             far better split into byte planes — the T64/Gorilla role)
  zstd       Zstandard, where the ``zstandard`` module is installed;
             ``default_codec`` picks it (and deltazstd for wide integers)
             then, DEFLATE otherwise, as the JAX package does
  lz         the native LZ4-class block codec (csrc/host/msdb_host.cpp)

Every encoded buffer is framed with magic, codec id, raw size, and a crc32
(the reference checksums every compressed frame the same way,
src/Compression/CompressedReadBufferBase.cpp).
"""

from __future__ import annotations

import struct
import threading
import zlib

import numpy as np

MAGIC = b"MSC1"
CODECS = {"none": 0, "zlib": 1, "delta": 2, "shuffle": 3, "lz": 4, "zstd": 5,
          "deltazstd": 6}
CODEC_IDS = {v: k for k, v in CODECS.items()}

try:
    import zstandard as _zstd
except ImportError:
    _zstd = None

# zstandard's (de)compressor objects are not thread-safe, and parts are
# read on a thread pool (table_store.load): one pair per thread.  The JAX
# package shares one module-level pair, whose concurrent reads can fail
# ("Data corruption detected") or crash the process.
_local = threading.local()


def _zc():
    if getattr(_local, "zc", None) is None:
        _local.zc = _zstd.ZstdCompressor(level=3)
    return _local.zc


def _zd():
    if getattr(_local, "zd", None) is None:
        _local.zd = _zstd.ZstdDecompressor()
    return _local.zd


class CodecError(ValueError):
    pass


def _delta_encode(arr: np.ndarray) -> bytes:
    d = np.diff(arr, prepend=arr.dtype.type(0))
    return zlib.compress(d.tobytes(), 6)


def _delta_decode(raw: bytes, dtype, count: int) -> np.ndarray:
    d = np.frombuffer(zlib.decompress(raw), dtype=dtype, count=count)
    return np.cumsum(d, dtype=dtype)


def _shuffle_encode(arr: np.ndarray) -> bytes:
    b = arr.view(np.uint8).reshape(-1, arr.dtype.itemsize)
    planes = np.ascontiguousarray(b.T)
    return zlib.compress(planes.tobytes(), 6)


def _shuffle_decode(raw: bytes, dtype, count: int) -> np.ndarray:
    dtype = np.dtype(dtype)
    planes = np.frombuffer(zlib.decompress(raw), dtype=np.uint8)
    planes = planes.reshape(dtype.itemsize, count)
    return np.ascontiguousarray(planes.T).reshape(-1).view(dtype)[:count]


def encode(arr: np.ndarray, codec: str = "zlib") -> bytes:
    arr = np.ascontiguousarray(arr)
    flat = arr.reshape(-1)
    if codec == "none":
        payload = flat.tobytes()
    elif codec == "zlib":
        payload = zlib.compress(flat.tobytes(), 6)
    elif codec == "delta":
        if flat.dtype.kind not in "iu":
            raise CodecError("delta codec requires integer data")
        payload = _delta_encode(flat)
    elif codec == "shuffle":
        payload = _shuffle_encode(flat)
    elif codec == "zstd":
        if _zstd is None:
            raise CodecError("zstandard module unavailable")
        payload = _zc().compress(flat.tobytes())
    elif codec == "deltazstd":
        if flat.dtype.kind not in "iu":
            raise CodecError("deltazstd codec requires integer data")
        if _zstd is None:
            raise CodecError("zstandard module unavailable")
        d = np.diff(flat, prepend=flat.dtype.type(0))
        payload = _zc().compress(d.tobytes())
    elif codec == "lz":
        # native LZ4-class block codec (csrc/host/msdb_host.cpp); much
        # faster than DEFLATE on the part-write path
        from myscaledb_tpu_torch import native
        payload = native.lz_compress(flat.tobytes())
    else:
        raise CodecError(f"unknown codec {codec!r}")
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    header = MAGIC + struct.pack("<BQI", CODECS[codec], flat.nbytes, crc)
    return header + payload


def decode(buf: bytes, dtype, count: int) -> np.ndarray:
    if buf[:4] != MAGIC:
        raise CodecError("bad magic in compressed frame")
    codec_id, raw_size, crc = struct.unpack("<BQI", buf[4:4 + 13])
    payload = buf[4 + 13:]
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise CodecError("checksum mismatch — corrupted column file")
    codec = CODEC_IDS[codec_id]
    dtype = np.dtype(dtype)
    if codec == "none":
        return np.frombuffer(payload, dtype=dtype, count=count)
    if codec == "zlib":
        return np.frombuffer(zlib.decompress(payload), dtype=dtype,
                             count=count)
    if codec == "delta":
        return _delta_decode(payload, dtype, count)
    if codec == "shuffle":
        return _shuffle_decode(payload, dtype, count)
    if codec in ("zstd", "deltazstd") and _zstd is None:
        raise CodecError("zstandard module unavailable: cannot read a "
                         f"{codec} frame")
    if codec == "zstd":
        return np.frombuffer(_zd().decompress(payload, max_output_size=raw_size),
                             dtype=dtype, count=count)
    if codec == "deltazstd":
        d = np.frombuffer(_zd().decompress(payload, max_output_size=raw_size),
                          dtype=dtype, count=count)
        return np.cumsum(d, dtype=dtype)
    if codec == "lz":
        from myscaledb_tpu_torch import native
        return np.frombuffer(native.lz_decompress(payload, raw_size),
                             dtype=dtype, count=count)
    raise CodecError(f"unknown codec id {codec_id}")


def default_codec(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype.kind in "iu" and dtype.itemsize >= 4:
        return "deltazstd" if _zstd is not None else "delta"
    if dtype.kind == "f":
        return "shuffle"
    return "zstd" if _zstd is not None else "zlib"
