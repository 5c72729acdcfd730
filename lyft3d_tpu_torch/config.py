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
import re
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
    """Write ``to_dict(cfg)`` with :func:`dump_yaml`: the bytes of
    ``yaml.safe_dump(..., sort_keys=False)``, with or without pyyaml."""
    path = Path(path)
    path.write_text(dump_yaml(to_dict(cfg)))
    return path


# -- a yaml writer for plain data, byte-equal to pyyaml's safe_dump ----------
# The implicit resolvers of pyyaml's ``Resolver`` (YAML 1.1), by first
# character: a string that one of them matches is quoted, or it would load
# as another type.
_RESOLVERS = (
    ("yYnNtTfFoO", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X)),
    ("-+0123456789.", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)),
    ("-+0123456789", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)),
    ("<", re.compile(r"^(?:<<)$")),
    ("~nN", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X)),
    ("0123456789", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)),
    ("=", re.compile(r"^(?:=)$")),
    ("!&*", re.compile(r"^(?:!|&|\*)$")),
)
_BREAKS = "\n\x85\u2028\u2029"
_SPACES = "\0 \t\r\n\x85\u2028\u2029"
_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v", "\x0c": "f",
            "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N", "\xa0": "_",
            "\u2028": "L", "\u2029": "P"}


def _loads_as_str(text: str) -> bool:
    """Whether ``text`` written plain reads back as a string."""
    if not text:
        return False  # null
    return not any(text[0] in chars and rx.match(text) for chars, rx in _RESOLVERS)


def _scalar_text(value) -> Tuple[str, bool]:
    """``(text, is_str)`` of a scalar as pyyaml's ``SafeRepresenter``
    writes it."""
    if value is None:
        return "null", False
    if isinstance(value, bool):
        return ("true" if value else "false"), False
    if isinstance(value, int):
        return str(value), False
    if isinstance(value, float):
        if value != value:
            return ".nan", False
        if value in (float("inf"), float("-inf")):
            return (".inf" if value > 0 else "-.inf"), False
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, False
    if isinstance(value, str):
        return value, True
    raise TypeError(f"cannot represent an object: {value!r}")


def _analyze(text: str) -> dict:
    """pyyaml's ``Emitter.analyze_scalar`` with ``allow_unicode=False``:
    which styles may write ``text``."""
    if not text:
        return dict(empty=True, multiline=False, block_plain=True, single=True)
    block_ind = breaks = special = False
    lead_space = lead_break = trail_space = trail_break = break_space = space_break = False
    if text.startswith("---") or text.startswith("..."):
        block_ind = True
    preceded = True
    followed = len(text) == 1 or text[1] in _SPACES
    prev_space = prev_break = False
    for i, ch in enumerate(text):
        if i == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed):
                block_ind = True
        elif (ch == ":" and followed) or (ch == "#" and preceded):
            block_ind = True
        if ch in _BREAKS:
            breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True
        if ch == " ":
            lead_space = lead_space or i == 0
            trail_space = trail_space or i == len(text) - 1
            break_space = break_space or prev_break
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            lead_break = lead_break or i == 0
            trail_break = trail_break or i == len(text) - 1
            space_break = space_break or prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded = ch in _SPACES
        followed = i + 2 >= len(text) or text[i + 2] in _SPACES
    block_plain = not (lead_space or lead_break or trail_space or trail_break or break_space
                       or space_break or special or breaks or block_ind)
    single = not (break_space or space_break or special)
    return dict(empty=False, multiline=breaks, block_plain=block_plain, single=single)


class _YamlWriter:
    """The part of pyyaml's ``Emitter`` that ``safe_dump`` of plain data
    runs (block style, empty collections in flow style, width 80, indent 2,
    no anchors: ``to_dict`` shares no list or dict between two places)."""

    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []
        self.open_ended = False

    def write(self, data: str):
        self.column += len(data)
        self.out.append(data)

    def indicator(self, text, need_whitespace, whitespace=False, indention=False):
        self.write(text if self.whitespace or not need_whitespace else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def line_break(self, data="\n"):
        self.out.append(data)
        self.whitespace = self.indention = True
        self.column = 0

    def write_indent(self):
        indent = self.indent or 0
        if not self.indention or self.column > indent or (self.column == indent and not self.whitespace):
            self.line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def push_indent(self, indentless=False):
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 0
        elif not indentless:
            self.indent += 2

    def node(self, value, mapping=False, simple_key=False):
        if isinstance(value, (list, tuple)) and value:
            self.push_indent(indentless=mapping and not self.indention)
            for item in value:
                self.write_indent()
                self.indicator("-", True, indention=True)
                self.node(item)
            self.indent = self.indents.pop()
        elif isinstance(value, dict) and value:
            self.push_indent()
            for k, v in value.items():
                self.write_indent()
                if self.simple_key(k):
                    self.node(k, mapping=True, simple_key=True)
                    self.indicator(":", False)
                else:
                    self.indicator("?", True, indention=True)
                    self.node(k, mapping=True)
                    self.write_indent()
                    self.indicator(":", True, indention=True)
                self.node(v, mapping=True)
            self.indent = self.indents.pop()
        elif isinstance(value, (list, tuple, dict)):
            self.indicator("[" if isinstance(value, (list, tuple)) else "{", True, whitespace=True)
            self.indicator("]" if isinstance(value, (list, tuple)) else "}", False)
        else:
            self.scalar(value, simple_key)

    def simple_key(self, key) -> bool:
        text, _ = _scalar_text(key)
        a = _analyze(text)
        return len(text) < 128 and not a["empty"] and not a["multiline"]

    def scalar(self, value, simple_key):
        text, is_str = _scalar_text(value)
        a = _analyze(text)
        split = not simple_key
        implicit = _loads_as_str(text) if is_str else True
        root = self.indent is None
        self.indents.append(self.indent)  # continuation lines sit one step in
        self.indent = 2 if root else self.indent + 2
        if implicit and not (simple_key and (a["empty"] or a["multiline"])) and a["block_plain"]:
            self.plain(text, split)
            self.open_ended = root
        elif a["single"] and not (simple_key and a["multiline"]):
            self.single_quoted(text, split)
        else:
            self.double_quoted(text, split)
        self.indent = self.indents.pop()

    def plain(self, text, split):
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > 80 and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def breaks(self, text, start, end):
        if text[start] == "\n":
            self.line_break()
        for br in text[start:end]:
            self.line_break("\n" if br == "\n" else br)
        self.write_indent()

    def single_quoted(self, text, split):
        self.indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > 80 and split and start != 0
                            and end != len(text)):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    self.breaks(text, start, end)
                    start = end
            elif (ch is None or ch in " " + _BREAKS or ch == "'") and start < end:
                self.write(text[start:end])
                start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces, breaks = ch == " ", ch in _BREAKS
            end += 1
        self.indicator("'", False)

    def double_quoted(self, text, split):
        self.indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        self.write("\\" + _ESCAPES[ch])
                    elif ch <= "\xff":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uffff":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > 80 and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.indicator('"', False)


def dump_yaml(data) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` without pyyaml, for what
    :func:`to_dict` gives: dicts, lists and tuples of str, int, float, bool
    and None."""
    w = _YamlWriter()
    w.node(data)
    w.write_indent()  # the document's end
    if w.open_ended:
        w.write("...")
        w.write_indent()
    return "".join(w.out)


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
