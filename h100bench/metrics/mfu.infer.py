"""The whole inference step's share of the chip's bfloat16 peak: the model's
operations over the traced window (:mod:`h100bench.counts.voxelnet`) over
its seconds times 989 TFLOP/s."""

from h100bench.counts.peaks import BF16_PEAK


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or run.work.get("flops", 0.0) <= 0:
        return None
    return 100.0 * run.work["flops"] / (t.window_s * BF16_PEAK)
