"""Zstandard decompression for reading Orbax checkpoints (``utils/ocdbt.py``),
through the port's own decoder ``native/zstd_decode.cc`` (RFC 8878, no
dictionaries).

The card's machine has no zstd library and nothing can be installed there,
so the decoder is part of the port: built with ``g++`` at first use into
``native/build/`` and bound through ``ctypes``, as ``data/native_loader.py``
builds ``native/loader.cc``.  A failed build raises with the compiler's
message; there is no other decoder to fall back to.  Corrupt or truncated
input raises `ZstdError` and returns no bytes.
"""

from __future__ import annotations

import ctypes
import os
import threading

from regnet_for_3d_grasping_torch.utils.native import NATIVE_DIR, build_shared

SOURCE = os.path.join(NATIVE_DIR, "zstd_decode.cc")
BUILD_DIR = os.path.join(NATIVE_DIR, "build")
COMPILER = "g++"


class ZstdError(ValueError):
    """The input is not a whole, valid zstd stream."""


def build_library(force: bool = False) -> str:
    """Compile ``native/zstd_decode.cc`` where the library is missing or
    older than the source; returns the library's path, or raises
    RuntimeError with the compiler's output."""
    return build_shared(SOURCE, os.path.join(BUILD_DIR, "libregnet_zstd.so"),
                        COMPILER, [], "the zstd decoder", force)


_lib = None
_lib_lock = threading.Lock()


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.regnet_zstd_decode.restype = ctypes.c_int
            lib.regnet_zstd_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t, ctypes.POINTER(u8p),
                ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
                ctypes.c_size_t]
            lib.regnet_zstd_free.restype = None
            lib.regnet_zstd_free.argtypes = [u8p]
            lib.regnet_xxh64.restype = ctypes.c_uint64
            lib.regnet_xxh64.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                         ctypes.c_uint64]
            lib.regnet_crc32c.restype = ctypes.c_uint32
            lib.regnet_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
            _lib = lib
    return _lib


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in `data`, one after another
    (skippable frames skipped); raises `ZstdError` on anything else."""
    data = bytes(data)
    lib = _library()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_size_t()
    err = ctypes.create_string_buffer(256)
    if lib.regnet_zstd_decode(data, len(data), ctypes.byref(out),
                              ctypes.byref(size), err, len(err)) != 0:
        raise ZstdError(f"zstd: {err.value.decode()}")
    try:
        return ctypes.string_at(out, size.value)
    finally:
        lib.regnet_zstd_free(out)


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the checksum of a zstd frame is its low 32 bits)."""
    data = bytes(data)
    return int(_library().regnet_xxh64(data, len(data), seed))


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`: the checksum that ends every OCDBT
    manifest and B+tree node."""
    data = bytes(data)
    return int(_library().regnet_crc32c(data, len(data)))
