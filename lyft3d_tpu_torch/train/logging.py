"""Metric logging: flat text + line-delimited JSON + optional TensorBoard.

Capability of the reference's ``SimpleModelLog``
(``second/utils/log_tool.py:41-130``): four sinks (log.txt, log.json.lst
reloaded on resume, tensorboard scalars, a scalars-json dump), nested-dict
flattening (:6-38).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict

__all__ = ["flatten_metrics", "MetricLog"]


def flatten_metrics(d: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_metrics(v, key))
        else:
            try:
                out[key] = float(v)
            except (TypeError, ValueError):
                out[key] = str(v)
    return out


class MetricLog:
    def __init__(self, model_dir, use_tensorboard: bool = True):
        self.model_dir = Path(model_dir)
        self.model_dir.mkdir(parents=True, exist_ok=True)
        self._txt = open(self.model_dir / "log.txt", "a")
        self._jsonl = open(self.model_dir / "log.json.lst", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter

                self._tb = SummaryWriter(str(self.model_dir / "tb"))
            except Exception:
                self._tb = None

    def log_text(self, text: str, step: int = 0) -> None:
        line = f"[step {step}] {text}"
        print(line)
        self._txt.write(line + "\n")
        self._txt.flush()
        if self._tb is not None:
            self._tb.add_text("log", text, step)

    def log_metrics(self, metrics: Dict[str, Any], step: int) -> None:
        flat = flatten_metrics(metrics)
        self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **flat}) + "\n")
        self._jsonl.flush()
        parts = ", ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in flat.items()
        )
        self._txt.write(f"[step {step}] {parts}\n")
        self._txt.flush()
        if self._tb is not None:
            for k, v in flat.items():
                if isinstance(v, float):
                    self._tb.add_scalar(k, v, step)

    def reload_history(self):
        """Past jsonl entries (the resume behavior of SimpleModelLog)."""
        fp = self.model_dir / "log.json.lst"
        if not fp.exists():
            return []
        out = []
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
        return out

    def close(self):
        self._txt.close()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
