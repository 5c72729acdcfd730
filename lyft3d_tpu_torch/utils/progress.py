"""Minimal progress bar (capability of second/utils/progress_bar.py)."""

from __future__ import annotations

import sys
import time

__all__ = ["ProgressBar", "progress_iter"]


class ProgressBar:
    def __init__(self, total: int, width: int = 40, stream=sys.stderr):
        self.total = max(total, 1)
        self.width = width
        self.stream = stream
        self.start = time.time()
        self.n = 0

    def update(self, n: int = 1) -> None:
        self.n += n
        frac = min(self.n / self.total, 1.0)
        filled = int(self.width * frac)
        elapsed = time.time() - self.start
        rate = self.n / max(elapsed, 1e-9)
        eta = (self.total - self.n) / max(rate, 1e-9)
        self.stream.write(
            f"\r[{'#' * filled}{'.' * (self.width - filled)}] "
            f"{self.n}/{self.total} {rate:.1f}/s eta {eta:.0f}s"
        )
        if self.n >= self.total:
            self.stream.write("\n")
        self.stream.flush()


def progress_iter(iterable, total=None):
    total = total if total is not None else len(iterable)
    bar = ProgressBar(total)
    for item in iterable:
        yield item
        bar.update()
