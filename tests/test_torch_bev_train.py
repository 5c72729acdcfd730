"""Port parity for BEV training: the box fill of the targets, the training
step (``make_bev_loss_fn`` + ``make_bev_optimizer_fn`` on the ``Trainer``),
``train_bev`` on the synthetic dataset, the SWA utilities and the CLI
commands, against the JAX package on the same inputs.

Tolerances: the box fill is exact (pixel centres lie 1e-3 px or more from
every edge of these boxes). Training, float32 on both sides: the per-step
loss within 1e-5 relative. Gradients cannot be held element by element in
float32: a ReLU input within rounding of 0 takes its sign from the order of
a float32 sum, and through the BatchNorm after it one such flip moves a
step's whole gradient by percents in the 2-norm. With the trunk in float64
on both sides the gradients agree to 1e-5 of each leaf
(``test_float64_trunk_gradients_match_jax``). So the float32 run holds the
gradient norm to 2e-2 relative, each parameter after the run to 2e-2 of how
far it moved from the start (plus 1e-6), and the running statistics to 1e-4
of their scale. The eval loss
1e-5 relative; SWA averages 1e-6; ``bn_update`` 1e-4 of the statistics'
scale: the JAX side extracts each batch's statistics from flax's moving
average, ``(new − 0.99·old)/0.01``, which multiplies the float32 rounding of
``0.99·old`` (about 1e-7 of ``old``) by 100.
"""

import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.config import BEVExperiment as JBEVExperiment
from lyft3d_tpu.config import OptimizerConfig as JOptimizerConfig
from lyft3d_tpu.data.bev_dataset import generate_bev_dataset as jgenerate
from lyft3d_tpu.data.bev_pipeline import BEVConfig as JBEVConfig
from lyft3d_tpu.data.lyftdb import LyftDB as JLyftDB
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models import build_model as jax_build_model
from lyft3d_tpu.ops import bev_raster as jraster
from lyft3d_tpu.pipelines import bev_train as jbev_train
from lyft3d_tpu.train import checkpoint as jckpt
from lyft3d_tpu.train import swa as jswa
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch import cli
from lyft3d_tpu_torch.config import BEVExperiment, OptimizerConfig
from lyft3d_tpu_torch.data import bev_dataset as tbev_dataset
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.ops import bev_raster as traster
from lyft3d_tpu_torch.pipelines import bev_train as tbev_train
from lyft3d_tpu_torch.train import checkpoint as tckpt
from lyft3d_tpu_torch.train import swa as tswa
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layers import randomized  # noqa: E402

SMALL = {"wf": 3, "depth": 2, "norm_type": "batch"}


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * max(float(np.abs(want).max()), 1e-6),
                               rtol=0)


# ------------------------------------------------------------------ box fill


def test_rasterize_boxes_bev_matches_jax():
    """Overlapping boxes (the later one wins), rotated ones, corners in both
    windings, boxes over the border, an invalid box on top, and no box."""
    rng = np.random.RandomState(0)
    centres = np.array([[20.3, 20.1], [26.2, 24.7], [40.6, 10.4], [5.1, 50.2], [30.0, 30.0],
                        [55.4, 55.9], [22.2, 21.3]], np.float32)
    sizes = np.array([[12, 6], [9, 14], [5, 20], [16, 9], [40, 40], [14, 14], [6, 6]], np.float32)
    yaws = np.array([0.3, -1.1, 0.75, 2.2, 0.1, 0.45, 1.3], np.float32)
    c, s = np.cos(yaws), np.sin(yaws)
    local = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]], np.float32)
    corners = np.einsum("bkj,bij->bki", local[None] * sizes[:, None], np.stack(
        [np.stack([c, -s], -1), np.stack([s, c], -1)], 1)) + centres[:, None]
    corners[3] = corners[3, ::-1]  # clockwise
    corners = (corners + rng.uniform(-1e-2, 1e-2, corners.shape)).astype(np.float32)
    classes = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    valid = np.array([True, True, True, True, False, True, True])
    want = np.asarray(jraster.rasterize_boxes_bev(jnp.asarray(corners), jnp.asarray(classes),
                                                  jnp.asarray(valid), (64, 60)))
    got = traster.rasterize_boxes_bev(torch.from_numpy(corners), torch.from_numpy(classes),
                                      torch.from_numpy(valid), (64, 60))
    assert got.dtype == torch.int32 and got.shape == (64, 60)
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.unique(want)) == {0, 1, 2, 3, 4, 6, 7}  # 5 is invalid; 7 covers part of 1
    empty = traster.rasterize_boxes_bev(torch.zeros(0, 4, 2), torch.zeros(0, dtype=torch.int32),
                                        torch.zeros(0, dtype=torch.bool), (8, 8))
    assert not empty.any()


# ------------------------------------------------------------ training parity


class _Captured(Exception):
    pass


def jax_training_pieces(exp, tmp_path, monkeypatch):
    """The model, optimizer, loss function and initial variables the JAX
    ``train_bev`` builds for ``exp``, taken at ``init_or_resume``."""
    seen = {}

    class Capture(jtrainer.Trainer):
        def init_or_resume(self, params):
            seen.update(model=self.model, tx=self.tx, loss_fn=self.loss_fn, params=jax.device_get(params))
            raise _Captured

    monkeypatch.setattr(jbev_train, "Trainer", Capture)
    with pytest.raises(_Captured):
        jbev_train.train_bev(exp, tmp_path / "bev", tokens=[f"t{i}" for i in range(5)], dtype=jnp.float32)
    return seen


def bev_batch(seed, batch=2, hw=32):
    rng = np.random.RandomState(seed)
    image = rng.rand(batch, hw, hw, 6).astype(np.float32)
    label = rng.randint(0, 10, (batch, hw, hw)).astype(np.int32)
    label[:, : hw // 2] = 0  # mostly background, as BEV targets are
    return {"image": image, "label": label}


def test_training_steps_match_jax(tmp_path, monkeypatch):
    """Twelve microsteps of ``ranger`` with ``grad_accum`` 2 (six updates, the
    sixth a lookahead sync), ``clip_norm`` 5 and weight decay 0.01 on a
    BatchNorm UNet: equal losses at every microstep, equal parameters and
    running statistics at the end. The optimizer holds the parameters alone,
    so weight decay never reaches a running statistic."""
    opt = dict(name="ranger", lr=1e-3, weight_decay=0.01, clip_norm=5.0, grad_accum=2, total_steps=12)
    common = dict(model="unet_reference", model_kwargs=SMALL, bev_shape=(32, 32, 3), batch_size=2)
    jexp = JBEVExperiment(**common, optimizer=JOptimizerConfig(**opt), model_dir=str(tmp_path / "j"))
    exp = BEVExperiment(**common, optimizer=OptimizerConfig(**opt), model_dir=str(tmp_path / "t"))
    pieces = jax_training_pieces(jexp, tmp_path, monkeypatch)
    jtr = jtrainer.Trainer(pieces["model"], pieces["tx"], pieces["loss_fn"],
                           jtrainer.TrainerConfig(model_dir=str(tmp_path / "jrun"), donate_state=False))
    jstate = jtrainer.TrainState.create(pieces["params"], jtr.tx)

    model = load_flax_params(tbev_train.build_bev_model(exp, torch.float32, "cpu"), pieces["params"])
    optimizer_fn = tbev_train.make_bev_optimizer_fn(exp)
    trainer = Trainer(model, optimizer_fn, tbev_train.make_bev_loss_fn(exp, "cpu"),
                      TrainerConfig(model_dir=str(tmp_path / "trun")))
    state = TrainState(model, optimizer_fn)
    held = {id(p) for p in state.optimizer.param_groups[0]["params"]}
    assert not any(id(b) in held for b in model.buffers())
    assert len(held) == len(list(model.parameters()))
    for step in range(12):
        batch = bev_batch(step)
        jstate, jm = jtr._step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                  jax.random.PRNGKey(step))
        state, tm = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "ce", "bce", "dice", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-2)
    assert state.optimizer.param_groups[0]["count"] == 6 == state.optimizer.param_groups[0]["lookahead_step"]
    jparams = jax.device_get(jstate.params)
    got = export_flax_params(model)
    got_params, start = flat(got["params"]), flat(pieces["params"]["params"])
    for path, want in flat(jparams["params"]).items():
        moved = np.abs(want - start[path]).max()
        assert moved > 1e-6, path  # every leaf moved
        np.testing.assert_allclose(got_params[path], want, atol=2e-2 * moved + 1e-6, rtol=0,
                                   err_msg="/".join(path))
    got_stats = flat(got["batch_stats"])
    for path, want in flat(jparams["batch_stats"]).items():
        close(got_stats[path], want, 1e-4)


@pytest.mark.parametrize("seed", [0, 5])
def test_float64_trunk_gradients_match_jax(seed):
    """With the trunk in float64 on both sides (the class head stays float32
    in both, as the flax model fixes it), the BEV loss and its gradient
    agree leaf by leaf to 1e-5 of each leaf's 2-norm on the BatchNorm UNet of
    the test above: what float32 leaves of the parity there (ReLU inputs
    within rounding of 0, whose sign the order of a float32 sum decides) is
    rounding, not a difference of function."""
    from lyft3d_tpu.train.losses import bev_segmentation_loss as jloss
    from lyft3d_tpu_torch.train.losses import bev_segmentation_loss as tloss

    batch = bev_batch(seed)
    cw = (0.2,) + (1.0,) * 9
    v = jax.device_get(jax.jit(jax_build_model("unet_reference", n_classes=10, dtype=jnp.float32, **SMALL).init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["image"])))
    with jax.enable_x64(True):
        jm = jax_build_model("unet_reference", n_classes=10, dtype=jnp.float64, **SMALL)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v["params"])

        def loss(p):
            (lg, aux), _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]},
                                    jnp.asarray(batch["image"], jnp.float64), mutable=["batch_stats"])
            return jloss(lg, aux, jnp.asarray(batch["label"]), jnp.asarray(cw), 336.0)[0]

        want_loss, want = jax.value_and_grad(loss)(p64)
        want_loss, want = float(want_loss), flat(jax.device_get(want))
    model = load_flax_params(build_model("unet_reference", n_classes=10, **SMALL), v).double()
    model.head.float()
    model.dtype = torch.float64
    logits, aux = model.train()(torch.from_numpy(batch["image"]))
    got_loss = tloss(logits, aux, torch.from_numpy(batch["label"]), torch.tensor(cw), 336.0)[0]
    got_loss.backward()
    np.testing.assert_allclose(float(got_loss.detach()), want_loss, rtol=1e-5)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    got = flat(export_flax_params(model)["params"])
    for path, w in want.items():
        assert np.linalg.norm(got[path] - w) <= 1e-5 * np.linalg.norm(w), "/".join(path)


# ----------------------------------------------------------------- train_bev


@pytest.fixture(scope="module")
def bev_dir(tmp_path_factory):
    root = make_synthetic_lyft(tmp_path_factory.mktemp("bevtrain") / "lyft", num_scenes=1,
                               samples_per_scene=5, classes=["car", "truck"], seed=2,
                               points_per_sweep=2048)
    out = tmp_path_factory.mktemp("bevpng")
    jgenerate(JLyftDB(root, root / "data"), out, JBEVConfig(shape=(64, 64, 3), voxel_size=(1.0, 1.0, 1.5)))
    return root, out


def small_exp(cls, opt_cls, model_dir, **kw):
    return cls(model="unet_reference", model_kwargs=SMALL, bev_shape=(64, 64, 3), batch_size=2,
               optimizer=opt_cls(name="adam", lr=1e-3, clip_norm=None, grad_accum=1, total_steps=2),
               model_dir=str(model_dir), **kw)


def test_train_bev_split_checkpoint_eval_and_init_from(bev_dir, tmp_path, monkeypatch):
    """``train_bev(device="cpu")``: the JAX split, a checkpoint, an eval loss
    that equals the JAX eval on the JAX run's weights, and ``init_from``."""
    _, bev = bev_dir
    tokens = sorted({p.name.rsplit("_", 1)[0] for p in bev.glob("*_input.png")})
    assert len(tokens) == 5
    jseen, tseen = [], []

    def recording(cls, seen):
        class Recording(cls):
            def __init__(self, directory, toks, **kw):
                seen.append((list(toks), kw["augment"]))
                super().__init__(directory, toks, **kw)
        return Recording

    monkeypatch.setattr(jbev_train, "BEVImageDataset", recording(jbev_train.BEVImageDataset, jseen))
    monkeypatch.setattr(tbev_train, "BEVImageDataset", recording(tbev_train.BEVImageDataset, tseen))
    jstate, _ = jbev_train.train_bev(small_exp(JBEVExperiment, JOptimizerConfig, tmp_path / "j"), bev,
                                     log_every=1, eval_every=2, num_workers=1, dtype=jnp.float32)
    exp = small_exp(BEVExperiment, OptimizerConfig, tmp_path / "t")
    state, model = tbev_train.train_bev(exp, bev, log_every=1, eval_every=2, num_workers=1,
                                        dtype=torch.float32, device="cpu")
    assert tseen == jseen and [a for _, a in tseen] == [True, False]
    assert (len(tseen[0][0]), len(tseen[1][0])) == (4, 1)
    assert state.step == 2 and model is state.module and model.training
    reg = json.loads((tmp_path / "t" / "checkpoints.json").read_text())
    assert reg["latest"]["model"] == "model-2.ckpt" and reg["latest"]["best"] == "best-2.ckpt"
    assert (tmp_path / "t" / "experiment.yaml").exists()
    tlog = [json.loads(l) for l in (tmp_path / "t" / "log.json.lst").read_text().splitlines()]
    assert [l["step"] for l in tlog if "train.loss" in l] == [1, 2] and any("eval.loss" in l for l in tlog)

    # The eval function on the JAX run's weights gives the JAX run's eval loss.
    jlog = [json.loads(l) for l in (tmp_path / "j" / "log.json.lst").read_text().splitlines()]
    want = [l["eval.loss"] for l in jlog if "eval.loss" in l][-1]
    jweights = load_flax_params(tbev_train.build_bev_model(exp, torch.float32, "cpu"),
                                jax.device_get(jstate.params))
    val_ds = tbev_dataset.BEVImageDataset(bev, jseen[1][0], with_map=True, augment=False)
    got = tbev_train.make_bev_eval_fn(exp, val_ds, "cpu")(TrainState(jweights, lambda p: None))
    np.testing.assert_allclose(got["loss"], want, rtol=1e-5)
    assert jweights.training

    # init_from: the latest checkpoint named after the model, shape-matching
    # weights taken (here all of them), float32 masters where present.
    tckpt.save(tmp_path / "donor", state, name=exp.model, global_step=2)
    warm = small_exp(BEVExperiment, OptimizerConfig, tmp_path / "warm", init_from=str(tmp_path / "donor"))
    warm.optimizer.total_steps = 0
    _, started = tbev_train.train_bev(warm, bev, num_workers=1, dtype=torch.float32, device="cpu")
    for (k, a), b in zip(started.state_dict().items(), model.state_dict().values()):
        assert torch.equal(a, b), k
    empty = small_exp(BEVExperiment, OptimizerConfig, tmp_path / "cold", init_from=str(tmp_path / "none"))
    with pytest.raises(FileNotFoundError, match="has no 'unet_reference' checkpoint"):
        tbev_train.train_bev(empty, bev, dtype=torch.float32, device="cpu")


def test_train_bev_takes_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = small_exp(BEVExperiment, OptimizerConfig, tmp_path)
    with pytest.raises(RuntimeError, match="train_bev: no CUDA device found"):
        tbev_train.train_bev(exp, tmp_path)
    with pytest.raises(RuntimeError, match="make_bev_loss_fn: no CUDA device found"):
        tbev_train.make_bev_loss_fn(exp)


# ----------------------------------------------------------------------- SWA


def weight_trees(n, seed):
    rng = np.random.RandomState(seed)
    return [{"a": rng.randn(3, 4).astype(np.float32), "b": {"c": rng.randn(5).astype(np.float32)}}
            for _ in range(n)]


def flat_torch(tree):
    return {".".join(k): torch.from_numpy(v) for k, v in flat(tree).items()}


@pytest.mark.parametrize("fn", ["moving_average", "average_params"])
def test_averages_match_jax(fn):
    trees = weight_trees(4, 3)
    if fn == "moving_average":
        want = jswa.moving_average(trees[0], trees[1], 3)
        got = tswa.moving_average(flat_torch(trees[0]), flat_torch(trees[1]), 3)
    else:
        want = jswa.average_params(trees)
        got = tswa.average_params([flat_torch(t) for t in trees])
    for k, w in flat_torch(jax.device_get(want)).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def bn_unet():
    x = np.random.RandomState(4).rand(2, 32, 32, 6).astype(np.float32)
    jm = jax_build_model("unet_reference", n_classes=10, dtype=jnp.float32, **SMALL)
    v = randomized(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))), 5)
    return jm, v


def test_swa_from_checkpoints_matches_jax(bn_unet, tmp_path):
    """Three snapshots of a bfloat16 run: the average takes each parameter
    from its float32 master (the JAX side stores float32 parameters)."""
    jm, v = bn_unet
    rng = np.random.RandomState(6)
    sets = [jax.tree_util.tree_map(lambda a: (a + 0.1 * rng.randn(*a.shape)).astype(np.float32), v)
            for _ in range(3)]
    jpaths, tpaths = [], []
    for i, s in enumerate(sets):
        jpaths.append(jckpt.save(tmp_path / "j", {"params": s}, global_step=i))
        exact = load_flax_params(build_model("unet_reference", n_classes=10, **SMALL), s)
        model = load_flax_params(build_model("unet_reference", n_classes=10, dtype=torch.bfloat16, **SMALL), s)
        state = TrainState(model, lambda p: torch.optim.SGD(p, lr=0.1))
        with torch.no_grad():
            for (n, p), m in zip(model.named_parameters(), state.masters):
                m.copy_(dict(exact.named_parameters())[n])
        tpaths.append(tckpt.save(tmp_path / "t", state, global_step=i))
    want = jswa.swa_from_checkpoints(jpaths, {"params": v})
    avg = tswa.swa_from_checkpoints(tpaths, build_model("unet_reference", n_classes=10,
                                                        dtype=torch.bfloat16, **SMALL))
    assert all(t.dtype == torch.float32 for t in avg.values() if t.is_floating_point())
    averaged = build_model("unet_reference", n_classes=10, **SMALL)
    averaged.load_state_dict(avg)
    got = flat(export_flax_params(averaged))
    for path, w in flat(jax.device_get(want)).items():
        np.testing.assert_allclose(got[path], w, atol=1e-6, rtol=0, err_msg="/".join(path))


def test_bn_update_matches_jax(bn_unet):
    jm, v = bn_unet
    rng = np.random.RandomState(7)
    batches = [rng.rand(2, 32, 32, 6).astype(np.float32) for _ in range(3)]
    want = jswa.bn_update(jm, v, [jnp.asarray(b) for b in batches])["batch_stats"]
    model = load_flax_params(build_model("unet_reference", n_classes=10, **SMALL), v).eval()
    tswa.bn_update(model, [torch.from_numpy(b) for b in batches])
    assert not model.training
    got = flat(export_flax_params(model)["batch_stats"])
    for path, w in flat(jax.device_get(want)).items():
        np.testing.assert_allclose(got[path], w, atol=1e-4 * max(1.0, float(np.abs(w).max())), rtol=0,
                                   err_msg="/".join(path))
    # Without BatchNorm, or without a batch, nothing changes.
    before = {k: t.clone() for k, t in model.state_dict().items()}
    tswa.bn_update(model, [])
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())
    group = build_model("unet_reference", n_classes=10, wf=3, depth=2)
    assert tswa.bn_update(group, [torch.zeros(1, 32, 32, 6)]) is group
    assert not any(isinstance(m, BatchNorm) for m in group.modules())


# ----------------------------------------------------------------------- CLI


def test_cli_generate_train_and_run_experiments(bev_dir, tmp_path):
    """``generate-bev`` writes the JAX package's PNGs; ``train-bev`` and
    ``run-experiments`` train on the CPU with ``--device cpu``, and the queue
    survives a failing job and writes its summary."""
    import cv2
    import yaml

    root, small_bev = bev_dir
    out = tmp_path / "bev"
    cli.main(["generate-bev", "--data-root", str(root), "--out", str(out)])
    jout = tmp_path / "jbev"
    jgenerate(JLyftDB(root, root / "data"), jout, JBEVConfig())
    names = sorted(p.name for p in jout.iterdir())
    assert names == sorted(p.name for p in out.iterdir()) and len(names) == 15
    for name in names:
        np.testing.assert_array_equal(cv2.imread(str(out / name)), cv2.imread(str(jout / name)))

    small = ["model=unet_reference", "model_kwargs.wf=3", "model_kwargs.depth=1", "batch_size=1",
             "optimizer.total_steps=2", "optimizer.grad_accum=1"]
    cli.main(["train-bev", "--bev-dir", str(small_bev), "--model-dir", str(tmp_path / "run"),
              "--device", "cpu", "--set", *small])
    reg = json.loads((tmp_path / "run" / "checkpoints.json").read_text())
    assert reg["latest"]["model"] == "model-2.ckpt"

    good = tmp_path / "good.yaml"
    good.write_text(yaml.safe_dump({"model": "unet_reference", "model_dir": str(tmp_path / "run_good")}))
    bad = tmp_path / "bad.yaml"
    bad.write_text(yaml.safe_dump({"model": "no_such_model", "model_dir": str(tmp_path / "run_bad")}))
    summary = tmp_path / "summary.json"
    cli.main(["run-experiments", "--bev-dir", str(small_bev), "--configs", str(bad), str(good),
              "--summary", str(summary), "--device", "cpu", "--set", *small[1:]])
    recs = json.loads(summary.read_text())
    assert [r["status"] for r in recs] == ["failed", "ok"] and recs[1]["steps"] == 2
    assert "KeyError" in recs[0]["error"] and recs[0]["model_dir"] == str(tmp_path / "run_bad")
    assert (tmp_path / "run_good" / "checkpoints.json").exists()


def test_chip_smoke_bev_config_is_the_yaml():
    """``chip_smoke.py`` spells out ``configs/bev_seresnext101_map.yaml`` (the
    card's machine has no pyyaml); only the microbatch differs."""
    import runpy

    from lyft3d_tpu_torch.config import load_yaml

    repo = Path(__file__).resolve().parent.parent
    spelled = runpy.run_path(str(repo / "chip_smoke.py"), run_name="chip_smoke")["bev_train_config"]
    want = load_yaml(BEVExperiment, repo / "configs" / "bev_seresnext101_map.yaml")
    assert spelled("unet_seresnext101", batch_size=want.batch_size) == want
    assert spelled("unet_seresnext101").batch_size == 8
