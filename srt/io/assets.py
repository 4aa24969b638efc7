"""Asset resolution for the reference content tree.

The reference hardcodes Windows-relative literals
(``"..\\contents\\environment_map\\sky_2.png"``, ``Raytracing_n.cpp:269``
et al.). Here assets are looked up by content-relative path across a small
list of roots, so scenes degrade gracefully (warn + skip) when an asset is
absent — several reference assets are LFS-stripped
(``/root/reference/.MISSING_LARGE_BLOBS``: dragon.ply, MERL *.binary, ...).
"""
from __future__ import annotations

import os
import warnings

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Search roots for content-relative asset paths, first hit wins.
ASSET_ROOTS = [
    os.environ.get("SRT_ASSETS", ""),
    os.path.join(_REPO_ROOT, "assets"),
    "/root/reference/contents",
]


def find_asset(rel_path: str) -> str | None:
    """Resolve a content-relative path (e.g. ``models/bunny.ply``)."""
    rel = rel_path.replace("\\", "/")
    for root in ASSET_ROOTS:
        if not root:
            continue
        cand = os.path.join(root, rel)
        if os.path.isfile(cand):
            return cand
    return None


def require_asset(rel_path: str) -> str:
    path = find_asset(rel_path)
    if path is None:
        raise FileNotFoundError(
            f"asset {rel_path!r} not found under any of {ASSET_ROOTS}; "
            f"set SRT_ASSETS to a contents/ tree")
    return path


def load_image_asset(rel_path: str, fallback_color=(0.5, 0.5, 0.5),
                     fallback_size: int = 8) -> np.ndarray:
    """Decode an image asset to (ny, nx, 3) uint8.

    Falls back to a small constant-color stand-in (with a warning) when the
    file is missing, so asset-light environments can still build every scene.
    """
    from srt.io.image import load_image
    path = find_asset(rel_path)
    if path is None:
        warnings.warn(f"asset {rel_path!r} missing; using constant stand-in")
        c = (np.asarray(fallback_color, np.float32) * 255).astype(np.uint8)
        return np.broadcast_to(c, (fallback_size, fallback_size, 3)).copy()
    return load_image(path)
