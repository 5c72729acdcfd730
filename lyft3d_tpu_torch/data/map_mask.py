"""Rasterized drivable-surface map mask with world↔pixel transforms.

Capability match for the reference SDK's ``MapMask``
(``lyft_dataset_sdk/utils/map_mask.py:18-121``): binary mask with optional
dilation, the world→pixel affine, and point-on-mask queries. The map raster
is stored with row 0 at the top and world +y pointing up, so the y axis
flips: ``px = x / res``, ``py = H − y / res``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Tuple

import numpy as np


class MapMask:
    def __init__(self, path, resolution: float = 0.1):
        self.path = Path(path)
        assert resolution >= 0.1, "only supports down to 0.1 m/px resolution"
        self.resolution = float(resolution)
        self.foreground = 255
        self._base: Optional[np.ndarray] = None

    # -- raster ---------------------------------------------------------
    @property
    def base_mask(self) -> np.ndarray:
        """Raw uint8 raster (lazy-loaded, cached)."""
        if self._base is None:
            from PIL import Image

            Image.MAX_IMAGE_PIXELS = None  # Lyft maps exceed PIL's default cap
            img = Image.open(str(self.path))
            if img.mode not in ("L", "I;16", "I"):
                img = img.convert("L")
            self._base = np.asarray(img)
        return self._base

    def mask(self, dilation: float = 0.0) -> np.ndarray:
        """Binary (0/255) uint8 mask, foreground dilated by ``dilation`` meters."""
        binary = (self.base_mask > 0).astype(np.uint8) * self.foreground
        if dilation <= 0:
            return binary
        import cv2

        px = max(int(round(dilation / self.resolution)), 1)
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * px + 1, 2 * px + 1))
        return cv2.dilate(binary, kernel)

    # -- transforms -------------------------------------------------------
    @property
    def transform_matrix(self) -> np.ndarray:
        """3x3 affine mapping world (x, y) → pixel (px, py)."""
        h = self.base_mask.shape[0]
        inv_res = 1.0 / self.resolution
        return np.array(
            [[inv_res, 0.0, 0.0], [0.0, -inv_res, float(h)], [0.0, 0.0, 1.0]]
        )

    def to_pixel_coords(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """World coords → integer pixel coords (arrays or scalars)."""
        x = np.atleast_1d(np.asarray(x, dtype=np.float64))
        y = np.atleast_1d(np.asarray(y, dtype=np.float64))
        pts = np.stack([x, y, np.ones_like(x)])
        px, py, _ = self.transform_matrix @ pts
        return np.round(px).astype(np.int64), np.round(py).astype(np.int64)

    def is_on_mask(self, x, y, dilation: float = 0.0) -> np.ndarray:
        """Boolean array: are the world points on the (dilated) mask?"""
        px, py = self.to_pixel_coords(x, y)
        mask = self.mask(dilation)
        h, w = mask.shape[:2]
        inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
        out = np.zeros(px.shape, dtype=bool)
        out[inside] = mask[py[inside], px[inside]] == self.foreground
        return out

    def crop_around(
        self, center_xy, extent_m: float, dilation: float = 0.0
    ) -> np.ndarray:
        """Square crop of the mask centered on a world point, zero-padded at
        the map border. Used by the BEV map-channel generator."""
        mask = self.mask(dilation)
        h, w = mask.shape[:2]
        half_px = int(round(extent_m / 2.0 / self.resolution))
        cx, cy = self.to_pixel_coords(center_xy[0], center_xy[1])
        cx, cy = int(cx[0]), int(cy[0])
        out = np.zeros((2 * half_px, 2 * half_px), dtype=mask.dtype)
        x0, x1 = cx - half_px, cx + half_px
        y0, y1 = cy - half_px, cy + half_px
        sx0, sy0 = max(x0, 0), max(y0, 0)
        sx1, sy1 = min(x1, w), min(y1, h)
        if sx1 > sx0 and sy1 > sy0:
            out[sy0 - y0 : sy1 - y0, sx0 - x0 : sx1 - x0] = mask[sy0:sy1, sx0:sx1]
        return out
