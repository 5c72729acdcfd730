"""The port's stage spans (``utils/profiler.py::span``): one shared context
that does nothing while no profiler runs, and under ``torch.profiler`` one
``lyft3d.*`` range a stage, nested as the layers call each other, for SECOND
inference (``make_second_infer_fn`` then ``to_host``), the training step
(``Trainer.step_fn`` on the SECOND loss) and greedy NMS's fixpoint steps."""

import numpy as np
import pytest
import torch

from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet, VoxelNetConfig
from lyft3d_tpu_torch.ops.anchors import AnchorSpec
from lyft3d_tpu_torch.ops.nms import nms_mask_from_iou
from lyft3d_tpu_torch.ops.voxelize import VoxelGrid
from lyft3d_tpu_torch.pipelines.bev import to_host
from lyft3d_tpu_torch.pipelines.second import make_second_infer_fn
from lyft3d_tpu_torch.pipelines.second_train import make_second_loss_fn
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from lyft3d_tpu_torch.utils import profiler

CFG = VoxelNetConfig(
    grid=VoxelGrid(point_cloud_range=(-16, -16, -3, 16, 16, 5), voxel_size=(1.0, 1.0, 8.0)),
    max_voxels=256, max_points_per_voxel=8, encoder="pillars", encoder_features=(16,),
    anchor_specs=(AnchorSpec(size=(2.0, 4.0, 1.6), z_center=0.0, matched_threshold=0.5,
                             unmatched_threshold=0.35, class_id=1),),
    rpn_layer_nums=(1, 1), rpn_strides=(2, 2), rpn_filters=(16, 32), rpn_up_strides=(1, 2),
    rpn_up_filters=(16, 16), nms_pre=64, nms_post=8)

BOXES = [(2.0, 3.0, 0.0, 2.0, 4.0, 1.6, 0.3), (-5.0, -6.0, 0.0, 2.0, 4.0, 1.6, -0.7)]


def batch(samples=2, n=384):
    """Clutter plus a cluster of points in each of ``BOXES``, every sample."""
    rng = np.random.RandomState(0)
    pts = rng.uniform(-15, 15, (samples, n, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2, 0, (samples, n))
    for i, (x, y, *_) in enumerate(BOXES):
        pts[:, 64 * i : 64 * (i + 1), :2] = rng.uniform(-1, 1, (samples, 64, 2)) + (x, y)
    boxes = np.zeros((samples, 4, 7), np.float32)
    boxes[:, : len(BOXES)] = BOXES
    return {"points": torch.from_numpy(pts), "points_valid": torch.ones(samples, n, dtype=torch.bool),
            "gt_boxes": torch.from_numpy(boxes), "gt_classes": torch.ones(samples, 4, dtype=torch.int32),
            "gt_valid": torch.arange(4).expand(samples, 4) < len(BOXES)}


def lyft3d_spans(prof):
    """``(name, parent)`` of each ``lyft3d.*`` span in the order they began;
    the parent is the innermost ``lyft3d.*`` span around it, or ``None``."""
    spans = sorted((e for e in prof.events() if e.name.startswith("lyft3d.")),
                   key=lambda e: (e.time_range.start, -e.time_range.end))
    out = []
    for i, e in enumerate(spans):
        around = [p for p in spans[:i] if p.thread == e.thread and p.time_range.end >= e.time_range.end]
        out.append((e.name, around[-1].name if around else None))
    return out


def profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_span_is_one_shared_noop_without_a_profiler(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    assert not torch.autograd._profiler_enabled()
    first = profiler.span("infer")
    assert profiler.span("nms.step") is first
    with first, profiler.span("to_host"):
        pass
    timers = profiler.SectionTimers(enabled=False)
    with timers.section("prep"):
        pass


def test_inference_spans_nest_as_the_layers_call():
    model = VoxelNet(CFG, in_features=4, generator=torch.Generator().manual_seed(1))
    infer = make_second_infer_fn(model, CFG)
    b = batch()
    want = to_host(infer(b["points"], b["points_valid"]))
    with profile() as prof:
        got = to_host(infer(b["points"], b["points_valid"]))
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    spans = lyft3d_spans(prof)
    parents = dict(spans)
    assert parents == {"lyft3d.infer": None, "lyft3d.voxelize": "lyft3d.infer",
                       "lyft3d.forward": "lyft3d.infer", "lyft3d.predict": "lyft3d.infer",
                       "lyft3d.rotated_iou": "lyft3d.predict", "lyft3d.nms": "lyft3d.predict",
                       "lyft3d.nms.step": "lyft3d.nms", "lyft3d.to_host": None}
    assert [n for n, p in spans if p is None] == ["lyft3d.infer", "lyft3d.to_host"]
    assert sum(n == "lyft3d.nms.step" for n, _ in spans) >= 1


def test_train_step_spans_nest_under_the_step(tmp_path):
    model = VoxelNet(CFG, in_features=4, generator=torch.Generator().manual_seed(2))
    trainer = Trainer(model, lambda params: build_optimizer(params, "adam", 1e-3),
                      make_second_loss_fn(CFG, device="cpu"),
                      TrainerConfig(model_dir=str(tmp_path), total_steps=2, log_every=10, eval_every=0,
                                    ckpt_every=0))
    state = trainer.init_or_resume()
    with profile() as prof:
        state, metrics = trainer.step_fn(state, batch())
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    spans = lyft3d_spans(prof)
    assert [n for n, p in spans if p == "lyft3d.step"] == [
        "lyft3d.targets", "lyft3d.forward", "lyft3d.loss", "lyft3d.backward", "lyft3d.optimizer"]
    assert dict(spans) == {"lyft3d.step": None, "lyft3d.targets": "lyft3d.step",
                           "lyft3d.voxelize": "lyft3d.targets", "lyft3d.assign_targets": "lyft3d.targets",
                           "lyft3d.forward": "lyft3d.step", "lyft3d.loss": "lyft3d.step",
                           "lyft3d.backward": "lyft3d.step", "lyft3d.optimizer": "lyft3d.step"}


def fixpoint_steps(iou, threshold):
    """Plain greedy NMS over score-sorted rows by the same recurrence, and
    the number of steps it takes to its fixpoint."""
    n = len(iou)
    keep, steps = [True] * n, 0
    while True:
        steps += 1
        new = [not any(keep[j] and iou[j][i] > threshold for j in range(i)) for i in range(n)]
        if new == keep:
            return keep, steps
        keep = new


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "traced"])
def test_nms_step_spans_count_the_fixpoint_steps(profiled):
    # A suppresses B; B overlaps C, so C survives once B is out: 3 steps.
    iou = [[1.0, 0.8, 0.0], [0.8, 1.0, 0.8], [0.0, 0.8, 1.0]]
    want, steps = fixpoint_steps(iou, 0.5)
    assert want == [True, False, True] and steps == 3
    scores = torch.tensor([0.9, 0.8, 0.7])
    if profiled:
        with profile() as prof:
            keep = nms_mask_from_iou(torch.tensor(iou), scores, 0.5, presorted=True)
        assert sum(e.name == "lyft3d.nms.step" for e in prof.events()) == steps
    else:
        keep = nms_mask_from_iou(torch.tensor(iou), scores, 0.5, presorted=True)
    assert keep.tolist() == want
