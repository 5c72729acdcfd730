"""Inputs of the port's learning demos (``tools/demo_*_e2e.py``): the
synthetic datasets the JAX demos build, at their seeds and sizes, written
once where PIL and cv2 are installed, and a *card form* of them that a
machine with numpy alone reads (the CUDA host has neither library, nor
pyyaml).

    python3 tools/demo_inputs.py [--out build/demo_inputs] [--tiny]

Layout under ``--out``:

- ``bev/lyft``, ``second/lyft``, ``pointrcnn/lyft``: the synthetic Lyft
  trees (``make_synthetic_lyft``; 4 scenes x 5 samples, 6 boxes of car /
  bus / truck, 16,384 points, seeds 123 and 321; PointRCNN 2 x 4, 4 cars,
  seed 7), with their map raster and camera images;
- ``bev/png``: ``generate_bev_dataset``'s PNGs of the BEV tree
  (``BEVConfig(num_sweeps=1, max_points=32768)``);
- ``pointrcnn/kitti``: ``export_kitti`` of the PointRCNN tree;
- ``card/``: the card form. ``card/bev/lyft`` and ``card/second/lyft`` hold
  the trees' JSON tables and lidar ``.bin`` files as they are;
  ``card/pointrcnn/kitti`` the KITTI tree's ``velodyne/``, ``calib/`` and
  ``label_2/``; ``card/bev/arrays.npz`` the BEV PNGs decoded by
  ``cv2.imread`` as ``BEVImageDataset.load`` decodes them (uint8
  ``input`` and ``map`` ``(N, H, W, 3)`` and ``target`` ``(N, H, W)`` of
  the sorted PNG tokens ``tokens``) and, for every sample of the tree,
  ``BEVSampleGenerator.map_channel`` as float32 ``infer_map`` ``(M, H,
  W)`` of ``infer_tokens``;
- ``meta.json``: what was built, with which sizes.

``--tiny`` builds the same layout at 1 scene x 4 samples of 2,048 points (the
CPU tests' size). The directory ``build/`` is ignored by git: build the
inputs where PIL and cv2 are installed and take the directory along with
the repository to the card's machine.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DEFAULT_OUT = ROOT / "build" / "demo_inputs"
CLASSES = ("car", "bus", "truck")
# The JAX demos' datasets (scripts/demo_{bev,second,pointrcnn}_e2e.py).
TREES = {
    "bev": dict(num_scenes=4, samples_per_scene=5, boxes_per_sample=6, classes=list(CLASSES),
                points_per_sweep=16384, seed=123),
    "second": dict(num_scenes=4, samples_per_scene=5, boxes_per_sample=6, classes=list(CLASSES),
                   points_per_sweep=16384, seed=321),
    "pointrcnn": dict(num_scenes=2, samples_per_scene=4, boxes_per_sample=4, classes=["car"],
                      points_per_sweep=16384, seed=7),
}
TINY = dict(num_scenes=1, samples_per_scene=4, points_per_sweep=2048)  # a SECOND batch of 4
BEV_CONFIG = dict(num_sweeps=1, max_points=32768)

__all__ = ["CLASSES", "TREES", "BEV_CONFIG", "build", "load_meta", "card_tree", "ensure", "torch_device",
           "synchronize", "main"]


def bev_config(meta: dict):
    """The demos' ``BEVConfig`` as ``meta.json`` records it."""
    from lyft3d_tpu_torch.data.bev_pipeline import BEVConfig

    return BEVConfig(**meta["bev_config"])


def _copy_lyft_tables(src: Path, dst: Path):
    """The JSON tables and the lidar sweeps of a Lyft tree: all that the
    demos read from it on a machine without an image library."""
    for sub, pattern in (("data", "*.json"), ("lidar", "*.bin")):
        (dst / sub).mkdir(parents=True, exist_ok=True)
        for f in sorted((src / sub).glob(pattern)):
            shutil.copy2(f, dst / sub / f.name)


def _bev_arrays(db, png_dir: Path, cfg, out: Path):
    """``arrays.npz``: the PNG dataset decoded as ``BEVImageDataset`` reads
    it, and each sample's inference map channel."""
    import cv2

    from lyft3d_tpu_torch.data.bev_pipeline import BEVSampleGenerator

    tokens = sorted({p.name.rsplit("_", 1)[0] for p in png_dir.glob("*_input.png")})
    inputs = np.stack([cv2.imread(str(png_dir / f"{t}_input.png")) for t in tokens])
    maps = np.stack([cv2.imread(str(png_dir / f"{t}_map.png")) for t in tokens])
    targets = np.stack([cv2.imread(str(png_dir / f"{t}_target.png"), cv2.IMREAD_GRAYSCALE) for t in tokens])
    gen = BEVSampleGenerator(db, cfg)
    infer_tokens = [s["token"] for s in db.sample]
    infer_map = np.stack([gen.map_channel(t) for t in infer_tokens]).astype(np.float32)
    np.savez_compressed(out, tokens=np.asarray(tokens), input=inputs, map=maps, target=targets,
                        infer_tokens=np.asarray(infer_tokens), infer_map=infer_map)


def build(out=DEFAULT_OUT, tiny: bool = False, families=("bev", "second", "pointrcnn")) -> Path:
    """Write the inputs of ``families`` under ``out`` (see the module's
    docstring); returns ``out``. Needs PIL and cv2."""
    from lyft3d_tpu_torch.data.bev_dataset import generate_bev_dataset
    from lyft3d_tpu_torch.data.kitti import export_kitti
    from lyft3d_tpu_torch.data.lyftdb import LyftDB
    from lyft3d_tpu_torch.data.synthetic import make_synthetic_lyft

    out = Path(out)
    meta = {"tiny": tiny, "bev_config": BEV_CONFIG, "classes": list(CLASSES), "trees": {}}
    card = out / "card"
    for family in families:
        kw = {**TREES[family], **(TINY if tiny else {})}
        shutil.rmtree(out / family, ignore_errors=True)
        shutil.rmtree(card / family, ignore_errors=True)
        root = make_synthetic_lyft(out / family / "lyft", **kw)
        meta["trees"][family] = kw
        db = LyftDB(root, root / "data")
        if family == "bev":
            cfg = bev_config(meta)
            generate_bev_dataset(db, out / "bev" / "png", cfg, [s["token"] for s in db.sample])
            _copy_lyft_tables(root, card / "bev" / "lyft")
            _bev_arrays(db, out / "bev" / "png", cfg, card / "bev" / "arrays.npz")
        elif family == "second":
            _copy_lyft_tables(root, card / "second" / "lyft")
        else:
            kitti = export_kitti(db, out / "pointrcnn" / "kitti")
            for sub in ("velodyne", "calib", "label_2"):
                shutil.copytree(kitti / sub, card / "pointrcnn" / "kitti" / sub)
    old = load_meta(out) if (out / "meta.json").exists() else {"trees": {}}
    if old.get("tiny") == tiny:
        meta["trees"] = {**old["trees"], **meta["trees"]}
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return out


def load_meta(inputs) -> dict:
    return json.loads((Path(inputs) / "meta.json").read_text())


def card_tree(inputs, family: str) -> Path:
    """The card form's tree of ``family`` under ``inputs``."""
    sub = {"bev": "bev/lyft", "second": "second/lyft", "pointrcnn": "pointrcnn/kitti"}[family]
    return Path(inputs) / "card" / sub


def ensure(inputs, family: str, tiny: bool = False) -> Path:
    """``inputs`` with ``family``'s inputs in it: built here when they are
    missing and PIL is installed; on a machine without it, build them
    elsewhere and copy them (``build/`` goes to the card with the repo)."""
    inputs = Path(inputs)
    if (inputs / "meta.json").exists() and family in load_meta(inputs)["trees"]:
        return inputs
    try:
        import PIL  # noqa: F401  (make_synthetic_lyft writes PNGs)
    except ImportError:
        raise SystemExit(f"{inputs} holds no {family} inputs and PIL is missing here: run "
                         f"`python3 tools/demo_inputs.py --out {inputs}` where PIL and cv2 are installed")
    return build(inputs, tiny=tiny, families=(family,))


def torch_device(name: str):
    """The demos' ``--device``: the card unless the caller asks for the
    CPU; without a card ``cuda`` raises."""
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device found (pass --device cpu to run on the CPU)")
    return device


def synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    ap.add_argument("--tiny", action="store_true", help="1 scene x 4 samples of 2,048 points")
    args = ap.parse_args(argv)
    out = build(args.out, tiny=args.tiny)
    print(json.dumps({"inputs": str(out), **load_meta(out)}))


if __name__ == "__main__":
    main()
