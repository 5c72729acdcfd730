"""Checkpoint manager: registry JSON + ``torch.save`` snapshots (port of
``lyft3d_tpu/train/checkpoint.py``).

A ``checkpoints.json`` registry per model_dir maps a name to all of its
checkpoints and the latest one; ``save`` honours ``max_to_keep``;
``restore_latest`` gives the auto-resume semantics. A snapshot is the
``state_dict`` of a train state (module, master parameters, optimizer, step),
a tree of tensors, numbers and containers, written to a temporary file and
renamed, so that an interrupt never leaves a half-written checkpoint. File
names are the JAX package's (``<name>-<step>.ckpt``); the contents are not
interchangeable with its msgpack files.
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

__all__ = [
    "save",
    "latest_checkpoint",
    "restore_latest",
    "restore",
    "load_trained_weights",
    "partial_restore",
    "load_partial",
    "list_checkpoints",
    "repeat_eval_checkpoints",
]

_REGISTRY = "checkpoints.json"


def _read_registry(model_dir: Path) -> Dict[str, Any]:
    fp = model_dir / _REGISTRY
    if fp.exists():
        with open(fp) as f:
            return json.load(f)
    return {"checkpoints": {}, "latest": {}}


def _write_registry(model_dir: Path, reg: Dict[str, Any]) -> None:
    tmp = model_dir / (_REGISTRY + ".tmp")
    with open(tmp, "w") as f:
        json.dump(reg, f, indent=2)
    os.replace(tmp, model_dir / _REGISTRY)


def save(model_dir, state, name: str = "model", global_step: int = 0, max_to_keep: int = 8) -> Path:
    """Snapshot ``state`` (a train state or a ``state_dict``) as
    ``{name}-{global_step}.ckpt``; prune old ones."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{name}-{global_step}.ckpt"
    tmp = model_dir / (fname + ".tmp")
    torch.save(state.state_dict() if hasattr(state, "state_dict") else state, tmp)
    os.replace(tmp, model_dir / fname)

    reg = _read_registry(model_dir)
    ckpts: List[str] = reg["checkpoints"].setdefault(name, [])
    ckpts.append(fname)
    reg["latest"][name] = fname
    while len(ckpts) > max_to_keep:
        old = ckpts.pop(0)
        try:
            (model_dir / old).unlink()
        except FileNotFoundError:
            pass
    _write_registry(model_dir, reg)
    return model_dir / fname


def latest_checkpoint(model_dir, name: str = "model") -> Optional[Path]:
    model_dir = Path(model_dir)
    fname = _read_registry(model_dir)["latest"].get(name)
    if fname and (model_dir / fname).exists():
        return model_dir / fname
    return None


def restore(path, target=None):
    """Load a snapshot. With a ``target`` train state, load it into the
    target (shape-checked by ``load_state_dict``) and return the target; else
    return the ``state_dict``, tensors on the CPU."""
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return loaded
    target.load_state_dict(loaded)
    return target


def restore_latest(model_dir, target=None, name: str = "model"):
    """``(state, step)``, or ``(target, None)`` if there is nothing to
    restore: the auto-resume semantics."""
    path = latest_checkpoint(model_dir, name)
    if path is None:
        return target, None
    step = int(re.match(rf"{re.escape(name)}-(\d+)\.ckpt", path.name).group(1))
    return restore(path, target), step


def load_trained_weights(module, snapshot):
    """Load the trained weights of a train state's snapshot (what
    ``restore_latest(model_dir)`` returns) into ``module``, built as the
    trained one was: the float32 master of each parameter that has one, the
    snapshot's module otherwise, each cast to ``module``'s dtype, so that a
    module gets the trained values and not a second rounding of them.
    Returns ``module``."""
    from lyft3d_tpu_torch.train.trainer import TrainState  # trainer imports this module

    weights = dict(snapshot["model"])
    weights.update(TrainState.masters_by_name(module, snapshot))
    module.load_state_dict(weights)
    return module


def partial_restore(params: Dict[str, torch.Tensor], donor_params: Dict[str, torch.Tensor],
                    include: Optional[str] = None, exclude: Optional[str] = None,
                    verbose: bool = False) -> Dict[str, torch.Tensor]:
    """A copy of the flat ``params`` (a module ``state_dict``) with the
    shape-matching entries of ``donor_params`` whose key matches ``include``
    and not ``exclude`` taken from the donor."""
    inc = re.compile(include) if include else None
    exc = re.compile(exclude) if exclude else None
    out, copied = {}, []
    for key, leaf in params.items():
        donor = donor_params.get(key)
        take = (
            donor is not None
            and tuple(donor.shape) == tuple(leaf.shape)
            and (inc is None or inc.search(key))
            and (exc is None or not exc.search(key))
        )
        out[key] = donor.to(dtype=leaf.dtype, device=leaf.device) if take else leaf
        if take:
            copied.append(key)
    if verbose:
        print(f"partial_restore: copied {len(copied)}/{len(params)} leaves")
    return out


def load_partial(module, snapshot, verbose: bool = False):
    """Load the shape-matching weights of ``snapshot`` into ``module`` (in
    place; returns it). ``snapshot`` is a train state's (its float32 masters
    where the architectures are the same) or a bare ``state_dict``."""
    from lyft3d_tpu_torch.train.trainer import TrainState  # trainer imports this module

    own = module.state_dict()
    donor = dict(snapshot["model"]) if "model" in snapshot else dict(snapshot)
    if "masters" in snapshot and donor.keys() == own.keys():
        donor.update(TrainState.masters_by_name(module, snapshot))
    module.load_state_dict(partial_restore(own, donor, verbose=verbose))
    return module


def list_checkpoints(model_dir, name: str = "model") -> List[Path]:
    """All registered checkpoints for ``name``, oldest first."""
    model_dir = Path(model_dir)
    reg = _read_registry(model_dir)
    return [model_dir / f for f in reg["checkpoints"].get(name, []) if (model_dir / f).exists()]


def repeat_eval_checkpoints(model_dir, eval_fn, name: str = "model", poll_interval: float = 1.0,
                            max_idle_polls: int = 5, record_file: str = "eval_done.json") -> Dict[int, Any]:
    """Checkpoint-watching repeat eval: poll the registry, evaluate every
    not-yet-evaluated checkpoint in step order with ``eval_fn(path, step)``,
    and keep the evaluated steps in ``record_file`` in the model dir so that
    a restart skips finished work. Stops after ``max_idle_polls`` polls in a
    row with no new checkpoint. Returns ``{step: result}`` for the
    checkpoints evaluated by this call."""
    model_dir = Path(model_dir)
    rec_path = model_dir / record_file
    done = set()
    if rec_path.exists():
        with open(rec_path) as f:
            done = set(json.load(f).get(name, []))
    results: Dict[int, Any] = {}
    idle = 0
    pat = re.compile(rf"{re.escape(name)}-(\d+)\.ckpt")
    while idle < max_idle_polls:
        fresh = []
        for path in list_checkpoints(model_dir, name):
            m = pat.match(path.name)
            if m and int(m.group(1)) not in done:
                fresh.append((int(m.group(1)), path))
        if not fresh:
            idle += 1
            time.sleep(poll_interval)
            continue
        idle = 0
        for step, path in sorted(fresh):
            results[step] = eval_fn(path, step)
            done.add(step)
            rec = {}
            if rec_path.exists():
                with open(rec_path) as f:
                    rec = json.load(f)
            rec[name] = sorted(done)
            tmp = model_dir / (record_file + ".tmp")
            with open(tmp, "w") as f:
                json.dump(rec, f)
            os.replace(tmp, rec_path)
    return results
