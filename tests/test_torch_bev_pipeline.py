"""Port parity for the whole BEV inference slice: synthetic Lyft dataset →
``BEVInferencePipeline.detect_all`` → world records → submission CSV → mAP,
in the JAX package and in the port, with ``unet_reference`` (wf=3, depth=2,
float32) and the same weights.

Random weights give no useful detections, so the class-0 head bias is raised
by the same amount in both packages until the JAX run finds a few
components per sample; the seed and bias below were chosen that way. A
precondition asserts that no pixel's foreground test sits within 1e-4 of
the threshold in logit space: the two packages' logits differ in their last
bits, and such a pixel could flip by chance.

Tolerances: scores 1e-5 (float32 softmax at the centroid); translations and
sizes 1e-4 m (float32 pixel boxes scaled by 0.8 m and moved by the ego
pose). The CSV and the mAP must be identical.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.data.bev_pipeline import BEVConfig
from lyft3d_tpu.data.lyftdb import LyftDB
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.eval.map_eval import evaluate_map
from lyft3d_tpu.eval.submission import records_from_detections, write_submission
from lyft3d_tpu.models import build_model as jax_build_model
from lyft3d_tpu.pipelines import bev as jbev
from lyft3d_tpu_torch import cli
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.pipelines import bev as tbev
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

CFG = BEVConfig(shape=(128, 128, 3), voxel_size=(0.8, 0.8, 1.5), max_points=8192)
MODEL_KW = {"n_classes": 10, "wf": 3, "depth": 2}
INIT_SEED = 2
BG_BIAS = 6.5


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    root = make_synthetic_lyft(tmp_path_factory.mktemp("lyft_port"), num_scenes=2,
                               samples_per_scene=2, seed=0)
    return LyftDB(root, root / "data")


@pytest.fixture(scope="module")
def flax_setup(db):
    model = jax_build_model("unet_reference", dtype=jnp.float32, **MODEL_KW)
    h, w, _ = CFG.shape
    variables = jax.device_get(
        jax.jit(model.init)(jax.random.PRNGKey(INIT_SEED), jnp.zeros((1, h, w, 6)))
    )
    head = variables["params"]["Conv_0"]
    bias = np.array(head["bias"])
    bias[0] += BG_BIAS
    variables["params"]["Conv_0"] = {**head, "bias": bias}
    return model, variables


@pytest.fixture(scope="module")
def both_runs(db, flax_setup):
    model, variables = flax_setup
    tokens = [s["token"] for s in db.sample]
    jax_pipe = jbev.BEVInferencePipeline(db, [(model, variables)], CFG)

    # Precondition on the JAX logits of every sample.
    arrays = [jax_pipe.gen.sample_arrays(t) for t in tokens]
    x = jax.vmap(lambda p, v, m: jbev.make_bev_input(p, v, m, CFG, backend="scatter"))(
        jnp.asarray(np.stack([a["points"][:, :3] for a in arrays])),
        jnp.asarray(np.stack([a["points_valid"] for a in arrays])),
        jnp.asarray(np.stack([a["map"] for a in arrays])),
    )
    lg = np.asarray(jax.jit(model.apply)(variables, x)[0]).astype(np.float64)
    m = lg.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(lg - m).sum(-1, keepdims=True)))[..., 0]
    margin = np.abs(lg[..., 0] - lse - np.log1p(-80.0 / 255.0))
    assert margin.min() >= 1e-4, f"a pixel is {margin.min():.2e} from the fg threshold"

    port_model = load_flax_params(build_model("unet_reference", **MODEL_KW), variables)
    port_pipe = tbev.BEVInferencePipeline(db, [port_model], CFG)
    return tokens, jax_pipe.detect_all(tokens), port_pipe.detect_all(tokens)


def test_jax_run_finds_a_few_boxes_per_sample(both_runs):
    tokens, jax_dets, _ = both_runs
    for tok in tokens:
        boxes = {tuple(np.round(d["translation"], 3)) for d in jax_dets[tok]}
        assert 1 <= len(boxes) <= 63, (tok, len(boxes))


def test_records_equal(both_runs):
    tokens, jax_dets, port_dets = both_runs
    assert set(port_dets) == set(jax_dets) == set(tokens)
    for tok in tokens:
        a, b = jax_dets[tok], port_dets[tok]
        assert len(b) == len(a), tok
        for ra, rb in zip(a, b):
            assert rb["name"] == ra["name"] and rb["sample_token"] == ra["sample_token"]
            np.testing.assert_allclose(rb["score"], ra["score"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(rb["translation"], ra["translation"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(rb["size"], ra["size"], atol=1e-4, rtol=0)
            np.testing.assert_allclose(rb["yaw"], ra["yaw"], atol=1e-5, rtol=0)
            np.testing.assert_allclose(rb["rotation"], ra["rotation"], atol=1e-5, rtol=0)


def test_csv_and_map_equal(db, both_runs, tmp_path):
    tokens, jax_dets, port_dets = both_runs
    a = write_submission(tmp_path / "jax.csv", jax_dets, tokens).read_text()
    b = write_submission(tmp_path / "port.csv", port_dets, tokens).read_text()
    assert b == a
    gt = tbev.gt_records(db, tokens)
    assert gt == jbev.gt_records(db, tokens)
    assert evaluate_map(gt, records_from_detections(port_dets)) == evaluate_map(
        gt, records_from_detections(jax_dets)
    )


def test_padded_batch_and_single_sample_agree(db, flax_setup, both_runs):
    """detect_sample pads a batch of 8 with copies; its records equal the
    batched run's."""
    tokens, _, port_dets = both_runs
    model = load_flax_params(build_model("unet_reference", **MODEL_KW), flax_setup[1])
    pipe = tbev.BEVInferencePipeline(db, [model], CFG)
    assert pipe.detect_sample(tokens[-1]) == port_dets[tokens[-1]]


def test_to_host_keeps_values_and_dtypes():
    det = {
        "boxes_px": torch.randn(2, 3, 5),
        "box_valid": torch.tensor([[True, False, True], [False, False, True]]),
        "counts": torch.tensor([[5, 0, 112896], [0, 1, 2]], dtype=torch.int32),
    }
    host = tbev.to_host(det)
    for k, v in det.items():
        assert host[k].dtype == v.numpy().dtype
        np.testing.assert_array_equal(host[k], v.numpy())


def test_cli_infer_bev(db, tmp_path):
    out = tmp_path / "sub.csv"
    data_root = db.data_path
    cli.main(["infer-bev", "--data-root", str(data_root), "--model", "unet_reference",
              "--out", str(out), "--device", "cpu"])
    lines = out.read_text().splitlines()
    assert lines[0] == "Id,PredictionString" and len(lines) == 1 + len(db.sample)
    # A model directory without a checkpoint keeps the initialisation.
    cli.main(["infer-bev", "--data-root", str(data_root), "--model",
              f"unet_reference:{tmp_path / 'no_run'}", "--out", str(out), "--device", "cpu"])
    assert out.read_text().splitlines() == lines


def _cli_models(db, tmp_path, monkeypatch, spec):
    """The modules ``infer-bev`` computes with for ``--model spec``."""
    seen = []

    class Recording(tbev.BEVInferencePipeline):
        def __init__(self, db_, models, *args, **kwargs):
            seen.extend(models)
            super().__init__(db_, models, *args, **kwargs)

    monkeypatch.setattr(tbev, "BEVInferencePipeline", Recording)
    cli.main(["infer-bev", "--data-root", str(db.data_path), "--model", spec,
              "--out", str(tmp_path / "sub.csv"), "--device", "cpu"])
    return seen


def _init_model(dtype=torch.float32):
    return build_model("unet_reference", n_classes=10, dtype=dtype,
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("trained_dtype", [torch.float32, torch.bfloat16])
def test_cli_infer_bev_restores_the_latest_checkpoint(db, tmp_path, monkeypatch, capsys, trained_dtype):
    """``infer-bev name:dir`` computes with the weights of the latest snapshot
    in the layout ``Trainer`` writes: the float32 masters of a bfloat16 run,
    not their bfloat16 rounding; an older snapshot is not taken."""
    from lyft3d_tpu_torch.train import checkpoint as ckpt
    from lyft3d_tpu_torch.train.trainer import TrainState

    rng = np.random.RandomState(7)
    state = TrainState(_init_model(trained_dtype), lambda ps: torch.optim.SGD(ps, lr=0.1))
    ckpt.save(tmp_path / "run", state, global_step=3)
    with torch.no_grad():
        for m in state.masters:  # trained values, finer than bfloat16 resolves
            m.add_(torch.from_numpy(0.01 * rng.randn(*m.shape).astype(np.float32)))
    state.pull_params()
    ckpt.save(tmp_path / "run", state, global_step=7)
    (model,) = _cli_models(db, tmp_path, monkeypatch, f"unet_reference:{tmp_path / 'run'}")
    assert f"unet_reference: restored step 7 from {tmp_path / 'run'}" in capsys.readouterr().out
    # By hand: the snapshot's buffers, then every parameter from its master.
    hand = _init_model()
    hand.load_state_dict(state.module.state_dict())
    with torch.no_grad():
        for p, m in zip(hand.parameters(), state.masters):
            p.copy_(m)
    init = _init_model()
    x = torch.from_numpy(rng.rand(1, 64, 64, 6).astype(np.float32))  # NHWC, as the JAX models
    with torch.no_grad():
        got, want, before = model.eval()(x)[0], hand.eval()(x)[0], init.eval()(x)[0]
    assert torch.equal(got, want)
    assert not torch.allclose(got, before, atol=1e-3)


def test_cli_infer_bev_without_a_checkpoint_keeps_the_init(db, tmp_path, monkeypatch, capsys):
    (tmp_path / "empty").mkdir()
    (model,) = _cli_models(db, tmp_path, monkeypatch, f"unet_reference:{tmp_path / 'empty'}")
    assert "restored" not in capsys.readouterr().out
    for a, b in zip(model.state_dict().values(), _init_model().state_dict().values()):
        assert torch.equal(a, b)


def test_cli_default_device_needs_a_card(db, tmp_path, monkeypatch):
    """Without a card the default device raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "sub.csv"
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["infer-bev", "--data-root", str(db.data_path), "--model", "unet_reference",
                  "--out", str(out)])
    assert not out.exists()
