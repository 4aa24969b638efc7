"""Image I/O: stb_image/stb_image_write equivalents.

The reference vendors stb for loading (``Raytracing_n.cpp:27-28``) and writes
hand-rolled ASCII PPM (``Raytracing_n.cpp:869-878,886``). Decoding assets
(jpg/png/tga) uses Pillow, imported only when an asset file exists; the
writers — the reference-compatible ``P3`` PPM and an 8-bit RGB PNG — need
nothing beyond the standard library.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Decode an image to (ny, nx, 3) uint8 (alpha dropped, like the
    reference's 3-channel assumption in ``texture.h:66-68``)."""
    from PIL import Image
    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), np.uint8)
    return arr


def write_ppm(path: str, img01) -> None:
    """ASCII ``P3`` PPM matching the reference's output format
    (``Raytracing_n.cpp:886`` header; ``:853-875`` 255.99 quantization)."""
    arr = np.asarray(img01)
    h, w, _ = arr.shape
    q = np.clip(255.99 * arr, 0, 255).astype(np.int32)
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = q.reshape(-1, 3)
        f.write("\n".join(f"{r} {g} {b}" for r, g, b in flat))
        f.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM -> (h, w, 3) uint8 (for golden comparisons)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    assert tokens[0] == "P3", "only ASCII P3 supported"
    w, h, maxv = int(tokens[1]), int(tokens[2]), int(tokens[3])
    data = np.asarray(tokens[4:4 + w * h * 3], np.int32).reshape(h, w, 3)
    return np.clip(data * 255 // maxv, 0, 255).astype(np.uint8)


def write_png(path: str, img01) -> None:
    """8-bit RGB PNG (same 255.99 quantization as :func:`write_ppm`):
    signature, IHDR, one zlib-compressed IDAT of filter-0 scanlines,
    IEND."""
    arr = np.clip(255.99 * np.asarray(img01), 0, 255).astype(np.uint8)
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          arr.reshape(h, w * 3)], axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
