"""Structured render metrics: rays/s, bounce histogram, NaN-scrub count.

The reference's observability is a ``\\r...%`` progress print and one
elapsed-ms line (``Raytracing_n.cpp:823,944-946``), plus two counters that
feed nothing (``bad_sample`` :54, ``goodsample_count`` :829-846). This module
is the srt replacement promised in SURVEY §5: every render can return a
:class:`RenderMetrics` with

* throughput — primary rays, total path vertices (ray segments actually
  traced), wall seconds, and the derived rates;
* the bounce histogram — how many lanes were alive entering each bounce
  (the depth distribution that motivates the regeneration engine);
* the NaN-scrub count — ``de_nan`` (``Raytracing_n.cpp:47-53``) zeroes NaN
  radiance channels; here each zeroing is counted, not silent.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    spp: int = 0
    max_depth: int = 0
    primary_rays: int = 0
    path_vertices: int = 0          # ray segments traced (sum of alive lanes)
    nan_scrubbed: int = 0           # radiance channels zeroed by de_nan
    wall_s: float = 0.0
    alive_per_bounce: np.ndarray | None = None  # (max_depth,) lanes entering
                                                # each bounce (scan engine)

    @property
    def primary_rays_per_sec(self) -> float:
        return self.primary_rays / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def vertices_per_sec(self) -> float:
        return self.path_vertices / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def mean_path_length(self) -> float:
        return (self.path_vertices / self.primary_rays
                if self.primary_rays else 0.0)

    def add_chunk(self, aux: dict) -> None:
        """Fold one compiled chunk's device-side counters in."""
        self.path_vertices += int(aux["path_vertices"])
        self.nan_scrubbed += int(aux["nan_scrubbed"])
        hist = np.asarray(aux["alive_per_bounce"])
        if self.alive_per_bounce is None:
            self.alive_per_bounce = hist.astype(np.int64)
        else:
            self.alive_per_bounce = self.alive_per_bounce + hist

    def to_dict(self) -> dict:
        d = {
            "width": self.width, "height": self.height, "spp": self.spp,
            "max_depth": self.max_depth,
            "primary_rays": self.primary_rays,
            "path_vertices": self.path_vertices,
            "mean_path_length": round(self.mean_path_length, 3),
            "nan_scrubbed": self.nan_scrubbed,
            "wall_s": round(self.wall_s, 3),
            "primary_rays_per_sec": round(self.primary_rays_per_sec, 1),
            "vertices_per_sec": round(self.vertices_per_sec, 1),
        }
        if self.alive_per_bounce is not None:
            d["alive_per_bounce"] = self.alive_per_bounce.tolist()
        return d
