"""Section timing + device profiling (port of ``lyft3d_tpu/utils/profiler.py``).

Capability of the reference's built-in profiler (``voxelnet.py:191-228``:
start_timer/end_timer pairs with a CUDA sync around the stages, averaged ms;
``second/utils/timer.py`` ``simple_timer``). A section's time is the host's
clock around its block; where the block hands a CUDA tensor it computed to
``set_sentinel``, the clock stops only after the card has finished the work
queued before it (PyTorch returns before the card does). :func:`trace` writes
a ``torch.profiler`` trace, the card's kernels included where there is one;
:func:`span` marks the program's stages in it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import torch

# The JAX package's names; :func:`span` is the port's own.
__all__ = ["SectionTimers", "simple_timer", "trace"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``lyft3d.<name>`` range in the running ``torch.profiler`` trace, on
    the profiler's clock beside the card's kernels; spans opened inside it
    on the same thread are its children. With no profiler running it is one
    shared context that does nothing: no sync, no tensor work, no
    allocation."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("lyft3d." + name)
    return _NO_SPAN


class SectionTimers:
    """Named running-average wall timers (enable like measure_time=True)."""

    def __init__(self, enabled: bool = True, sync: bool = True):
        self.enabled = enabled
        self.sync = sync
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str, sentinel=None):
        """Time a block; pass the block's output tensor via ``set_sentinel``
        so that the time covers the card's work on it. The block is also a
        :func:`span` of the same name."""
        with span(name):
            if not self.enabled:
                self._box = {}
                yield self
                return
            box = {}
            self._box = box
            t0 = time.perf_counter()
            yield self
            sentinel = box.get("sentinel")
            if self.sync and torch.is_tensor(sentinel) and sentinel.device.type == "cuda":
                torch.cuda.current_stream(sentinel.device).synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def set_sentinel(self, value):
        self._box["sentinel"] = value
        return value

    def averages_ms(self) -> Dict[str, float]:
        return {
            k: 1000.0 * self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }

    def clear(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        return ", ".join(f"{k}={v:.2f}ms" for k, v in sorted(self.averages_ms().items()))


@contextlib.contextmanager
def simple_timer(name: str = ""):
    """Print-elapsed context manager (second/utils/timer.py)."""
    t0 = time.perf_counter()
    yield
    print(f"{name} elapsed: {time.perf_counter() - t0:.4f}s")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of the block, written into ``log_dir`` as a
    ``*.pt.trace.json`` file (TensorBoard's profiler plugin or
    chrome://tracing read it), like ``jax.profiler``'s trace of the whole
    process: the host's operators of every thread (a server's requests run
    on its own threads), and the CUDA kernels when a card is present. Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(log_dir)),
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
