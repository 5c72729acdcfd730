"""Offline BEV dataset: PNG generation + training loader with augmentation
(the port's copy of ``lyft3d_tpu/data/bev_dataset.py``, numpy and cv2 only).

Capability of the reference's offline path:
- ``generating-dataset/generating_train_bev.py`` / ``generating_test_bev.py``
  — per-sample ``{token}_input.png`` (lidar voxel intensities),
  ``{token}_target.png`` (class-index map), ``{token}_map.png`` (drivable
  surface), restartable via existence checks, corrupt-sample skip;
- ``BEVImageDataset`` (``unet_baseline/unet-training-with-map.py:157-214`` /
  ``deeplab_v3_baseline/dataset/dataset.py:61-143``) — PNG → 6-channel float
  input + int target, with horizontal-flip + cutout augmentation (the
  albumentations HFlip/Cutout the reference uses).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig, BEVSampleGenerator
from lyft3d_tpu_torch.data.lyftdb import LyftDB

__all__ = ["numpy_bev_raster", "generate_bev_dataset", "BEVImageDataset",
           "index_batches", "batch_iterator"]


def numpy_bev_raster(points, cfg: BEVConfig) -> np.ndarray:
    """Host rasterization (bincount scatter) — the offline-generation twin of
    the device kernels in ``ops.bev_raster`` (tested equal)."""
    h, w, c = cfg.shape
    vx, vy, vz = cfg.voxel_size
    col = np.floor(points[:, 0] / vx + w / 2).astype(np.int64)
    row = np.floor(points[:, 1] / vy + h / 2).astype(np.int64)
    ch = np.floor((points[:, 2] - cfg.z_offset) / vz).astype(np.int64)
    ok = (col >= 0) & (col < w) & (row >= 0) & (row < h) & (ch >= 0) & (ch < c)
    flat = (row[ok] * w + col[ok]) * c + ch[ok]
    counts = np.bincount(flat, minlength=h * w * c).reshape(h, w, c)
    return np.clip(counts / 16.0, 0.0, 1.0).astype(np.float32)


def generate_bev_dataset(
    db: LyftDB,
    out_dir,
    cfg: BEVConfig = BEVConfig(),
    tokens: Optional[Sequence[str]] = None,
    with_targets: bool = True,
    overwrite: bool = False,
) -> List[str]:
    """Write input/target/map PNGs per sample; idempotent + fault-tolerant
    (existence check :182-183, per-sample try/except :207-233)."""
    import cv2

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = BEVSampleGenerator(db, cfg)
    tokens = list(tokens or (s["token"] for s in db.sample))
    done = []
    for tok in tokens:
        target_fp = out / f"{tok}_target.png"
        input_fp = out / f"{tok}_input.png"
        if not overwrite and input_fp.exists() and (
            not with_targets or target_fp.exists()
        ):
            done.append(tok)
            continue
        try:
            pts = gen.points_in_car_frame(tok)
            valid = pts[:, 3] >= 0
            bev = numpy_bev_raster(pts[valid], cfg)
            cv2.imwrite(str(input_fp), (bev * 255).astype(np.uint8))

            if with_targets:
                corners, classes, bvalid = gen.box_corners_px(tok)
                target = np.zeros(cfg.shape[:2], np.uint8)
                for i in range(len(corners)):
                    if not bvalid[i]:
                        continue
                    poly = np.round(corners[i]).astype(np.int32)
                    cv2.fillPoly(target, [poly], int(classes[i]))
                cv2.imwrite(str(target_fp), target)

            map_ch = gen.map_channel(tok)
            cv2.imwrite(
                str(out / f"{tok}_map.png"),
                np.repeat((map_ch * 255).astype(np.uint8)[..., None], 3, -1),
            )
            done.append(tok)
        except Exception as e:  # corrupt-sample skip (:207-233)
            print(f"skipping {tok}: {type(e).__name__}: {e}")
    return done


class BEVImageDataset:
    """PNG-backed training dataset with hflip + cutout augmentation."""

    def __init__(
        self,
        directory,
        tokens: Sequence[str],
        with_map: bool = True,
        augment: bool = False,
        cutout_holes: int = 8,
        cutout_size: int = 16,
        seed: int = 0,
    ):
        self.dir = Path(directory)
        self.tokens = list(tokens)
        self.with_map = with_map
        self.augment = augment
        self.cutout_holes = cutout_holes
        self.cutout_size = cutout_size
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        return len(self.tokens)

    def assemble(self, idxs: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stack a batch from indices (thread-safe: cv2 + numpy release the
        GIL; RandomState calls are individually locked)."""
        xs, ys = zip(*(self.load(i) for i in idxs))
        return {"image": np.stack(xs), "label": np.stack(ys)}

    def load(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        import cv2

        tok = self.tokens[idx]
        inp = cv2.imread(str(self.dir / f"{tok}_input.png")).astype(np.float32) / 255.0
        channels = [inp]
        if self.with_map:
            m = cv2.imread(str(self.dir / f"{tok}_map.png"))
            channels.append(m.astype(np.float32) / 255.0)
        x = np.concatenate(channels, axis=-1)  # (H, W, 3 or 6)
        tgt_fp = self.dir / f"{tok}_target.png"
        if tgt_fp.exists():
            y = cv2.imread(str(tgt_fp), cv2.IMREAD_GRAYSCALE).astype(np.int32)
        else:
            y = np.zeros(x.shape[:2], np.int32)

        if self.augment:
            if self.rng.rand() < 0.5:  # horizontal flip
                x = x[:, ::-1].copy()
                y = y[:, ::-1].copy()
            for _ in range(self.rng.randint(0, self.cutout_holes + 1)):
                h, w = x.shape[:2]
                cy = self.rng.randint(h)
                cx = self.rng.randint(w)
                s = self.cutout_size // 2
                x[max(cy - s, 0) : cy + s, max(cx - s, 0) : cx + s] = 0.0
        return x, y


def index_batches(
    n_items: int, batch_size: int, steps: int, seed: int = 0
) -> Iterator[List[int]]:
    """Shuffled epoch-cycling index chunks (per-epoch reseed like the
    reference's per-epoch seed bump, unet-training-with-map.py:334) — the
    cheap work stream for MappedPrefetcher."""
    rng = np.random.RandomState(seed)
    order: List[int] = []
    for _ in range(steps):
        while len(order) < batch_size:
            order.extend(rng.permutation(n_items).tolist())
        take, order = order[:batch_size], order[batch_size:]
        yield take


def batch_iterator(
    dataset: BEVImageDataset,
    batch_size: int,
    steps: int,
    seed: int = 0,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled epoch-cycling batches (single-threaded convenience)."""
    for take in index_batches(len(dataset), batch_size, steps, seed):
        yield dataset.assemble(take)
