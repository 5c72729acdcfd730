"""Unified typed experiment configuration.

One dataclass-based config system replacing the reference's three
(argparse flags in the BEV trainers, protobuf text configs in SECOND
(``second/protos/*.proto`` + ``text_format.Merge``, train.py:171-179),
YAML+EasyDict in PointRCNN (``lib/config.py``)) while preserving the
capabilities that matter:

- full experiment spec is text-serializable (YAML) and snapshotted next to
  checkpoints (``save_config_to_file`` / pipeline.config snapshot);
- nested per-class settings (anchors, sampler quotas);
- dotted-path overrides from the command line (``--set a.b.c=1``,
  cfg_from_list capability);
- registry dispatch by name (model/encoder selection).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, get_args, get_origin


__all__ = [
    "to_dict",
    "from_dict",
    "save_yaml",
    "load_yaml",
    "apply_overrides",
    "snapshot_config",
    "BEVExperiment",
    "SecondExperiment",
    "PointRCNNExperiment",
]


# -- generic dataclass <-> dict machinery ------------------------------------
def to_dict(cfg) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def _construct(tp, value):
    origin = get_origin(tp)
    if is_dataclass(tp) and isinstance(value, dict):
        return from_dict(tp, value)
    if origin in (tuple, Tuple) and isinstance(value, (list, tuple)):
        args = get_args(tp)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_construct(args[0], v) for v in value)
        if args:
            return tuple(_construct(a, v) for a, v in zip(args, value))
        return tuple(value)
    if origin in (list, List) and isinstance(value, (list, tuple)):
        args = get_args(tp)
        inner = args[0] if args else None
        return [(_construct(inner, v) if inner else v) for v in value]
    if origin in (dict, Dict) and isinstance(value, dict):
        return dict(value)
    if origin is not None and str(origin) == "typing.Union":  # Optional
        for a in get_args(tp):
            if a is type(None):
                if value is None:
                    return None
                continue
            try:
                return _construct(a, value)
            except (TypeError, ValueError):
                continue
        return value
    return value


def from_dict(cls, data: dict):
    """Recursively build dataclass ``cls`` from a plain dict (unknown keys
    rejected — typo protection the reference's EasyDict merge lacks)."""
    import typing

    hints = typing.get_type_hints(cls)
    kwargs = {}
    known = {f.name for f in fields(cls)}
    for key, value in data.items():
        if key not in known:
            raise KeyError(f"{cls.__name__}: unknown config key {key!r}")
        kwargs[key] = _construct(hints[key], value)
    return cls(**kwargs)


def save_yaml(cfg, path) -> Path:
    import yaml  # here, so that the module imports where pyyaml is missing

    path = Path(path)
    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
    return path


def load_yaml(cls, path):
    import yaml

    with open(path) as f:
        return from_dict(cls, yaml.safe_load(f) or {})


def apply_overrides(cfg, overrides: List[str]):
    """``a.b.c=value`` dotted overrides (cfg_from_list capability).

    Unknown keys are rejected (typo protection) EXCEPT below free-form
    ``Dict`` fields (e.g. ``model_kwargs.norm_type=batch``), where new keys
    are legitimate.
    """
    data = to_dict(cfg)
    for ov in overrides:
        key, _, raw = ov.partition("=")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = data
        parts = key.strip().split(".")
        # Free-form once the live-config walk crosses an actual dict field.
        live = cfg
        freeform = False
        for p in parts[:-1]:
            if isinstance(live, dict):
                freeform = True
                live = live.get(p)
            elif live is not None and hasattr(live, p):
                live = getattr(live, p)
                freeform = freeform or isinstance(live, dict)
            node = node.setdefault(p, {}) if freeform else node[p]
        if parts[-1] not in node and not freeform:
            raise KeyError(f"unknown override key: {key}")
        old = node.get(parts[-1])
        if isinstance(value, str) and not isinstance(old, str) and old is not None:
            # Non-JSON text like `(1,2)` silently becomes a string and fails
            # deep inside jit — catch it at the CLI boundary instead.
            raise ValueError(
                f"override {key}={raw!r} parsed as a string but the field is "
                f"{type(old).__name__}; use JSON syntax (e.g. [1,2,3], true, 1.5)"
            )
        node[parts[-1]] = value
    return from_dict(type(cfg), data)


def snapshot_config(cfg, model_dir) -> Path:
    """Write the resolved config next to the checkpoints (train.py:166-179)."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    return save_yaml(cfg, model_dir / "experiment.yaml")


# -- concrete experiment schemas ----------------------------------------------
@dataclass
class OptimizerConfig:
    name: str = "ranger"  # ranger | radam | adam | adamw | sgd | adam_onecycle
    lr: float = 1e-3
    weight_decay: float = 0.0
    clip_norm: Optional[float] = 5.0
    grad_accum: int = 4
    schedule: str = "one_cycle"  # one_cycle | cosine | warm_restarts | constant
    total_steps: int = 10000


@dataclass
class DataConfig:
    data_root: str = ""
    json_dir: str = "data"
    num_sweeps: int = 1
    max_points: int = 131072
    val_fraction: float = 1.0 / 6.0
    seed: int = 42


@dataclass
class BEVExperiment:
    model: str = "unet_seresnext101"
    model_kwargs: Dict[str, int] = field(default_factory=dict)
    n_classes: int = 10
    bev_shape: Tuple[int, int, int] = (336, 336, 3)
    voxel_size: Tuple[float, float, float] = (0.4, 0.4, 1.5)
    z_offset: float = -2.0
    box_scale: float = 0.8
    with_map: bool = True
    batch_size: int = 32
    class_weights: Tuple[float, ...] = (0.2,) + (1.0,) * 9
    size_weight: float = 336.0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    data: DataConfig = field(default_factory=DataConfig)
    model_dir: str = "/tmp/lyft3d_bev"
    # Directory holding an imported/pretrained checkpoint (cli import-weights);
    # shape-matching leaves are partial-restored at init (models/model.py:50-60
    # load_pretrain semantics).
    init_from: str = ""


@dataclass
class AnchorConfig:
    class_name: str = "car"
    size: Tuple[float, float, float] = (1.93, 4.76, 1.72)
    z_center: float = -1.0
    matched_threshold: float = 0.6
    unmatched_threshold: float = 0.45


@dataclass
class SecondExperiment:
    point_cloud_range: Tuple[float, float, float, float, float, float] = (
        -49.6, -49.6, -5.0, 49.6, 49.6, 3.0,
    )
    voxel_size: Tuple[float, float, float] = (0.25, 0.25, 8.0)
    max_voxels: int = 20000
    max_points_per_voxel: int = 20
    # Height-based ground removal (all.fhd.config:10-13 block_filtering).
    block_filtering: bool = False
    block_factor: int = 1
    block_size: int = 8
    height_threshold: float = 0.2
    encoder: str = "pillars"
    # scatter (pillars) | sparse_units (PRODUCTION sparse path) |
    # sparse_columns (measured alternative) | sparse (test oracle only)
    middle: str = "scatter"
    # Sparse middle sizing (middle == "sparse"): per-stage channel widths
    # and active-voxel caps of the strided sparse-conv stack
    # (SpMiddleFHD's downsample chain, second/pytorch/models/middle.py).
    middle_features: Tuple[int, ...] = (16, 32, 64)
    middle_max_voxels: Tuple[int, ...] = (8192, 4096, 2048)
    # Column-middle norm structure: layer | batch | folded (inference).
    middle_norm: str = "layer"
    # Stage-0 z-slab size of the "sparse_units" middle.
    middle_z_slab: int = 8
    similarity: str = "nearest"  # anchor matching: nearest | rotated
    anchors: Tuple[AnchorConfig, ...] = (AnchorConfig(),)
    # RPN topology (all.fhd.config rpn block: layer_nums, layer_strides,
    # num_filters, upsample_strides, num_upsample_filters). up_strides[0]
    # < 1 coarsens the anchor grid (the reference lands at ~62²).
    rpn_layer_nums: Tuple[int, ...] = (3, 5, 5)
    rpn_strides: Tuple[int, ...] = (2, 2, 2)
    rpn_filters: Tuple[int, ...] = (64, 128, 256)
    rpn_up_strides: Tuple[float, ...] = (1, 2, 4)
    rpn_up_filters: Tuple[int, ...] = (128, 128, 128)
    batch_size: int = 8
    num_sweeps: int = 10
    db_sampler_quota: Dict[str, int] = field(default_factory=dict)
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(name="adam_onecycle", lr=3e-3,
                                                total_steps=58650, grad_accum=1)
    )
    data: DataConfig = field(default_factory=DataConfig)
    model_dir: str = "/tmp/lyft3d_second"


@dataclass
class PointRCNNExperiment:
    num_points: int = 16384
    mode: str = "rpn"  # rpn | rcnn | joint
    optimizer: OptimizerConfig = field(
        default_factory=lambda: OptimizerConfig(name="adam_onecycle", lr=2e-3)
    )
    data: DataConfig = field(default_factory=DataConfig)
    model_dir: str = "/tmp/lyft3d_pointrcnn"


def change_detection_range(exp: SecondExperiment, new_range) -> SecondExperiment:
    """Return a copy of a SECOND experiment with a new detection range —
    the config-mutation helper capability (``second/utils/config_tool``'s
    ``change_detection_range_v2``, used by inference.py:43 to shrink the
    range for interactive demos)."""
    return dataclasses.replace(exp, point_cloud_range=tuple(new_range))
