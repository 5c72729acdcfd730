"""The port's trainer against the JAX package's, and its lifecycle.

From equal weights (flax init → ``load_flax_params``), two steps of
``Trainer`` in both packages on one fixed batch (pillars, tiny grid, ``adam``,
float32) give equal losses (1e-5 relative) and equal updated parameters
(``export_flax_params``; 1e-5 absolute on weights of order 1, which after two
Adam steps of 1e-3 each have moved by about 2e-3). Then: checkpoint save →
``init_or_resume`` restores step, parameters and optimizer state;
``max_to_keep``; checkpoint on failure; bfloat16 modules train through
float32 master parameters; ``train_second`` runs end to end on the synthetic
Lyft DB on the CPU.
"""

import json
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.pipelines import second_train as jtrain
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch.config import AnchorConfig, OptimizerConfig, SecondExperiment
from lyft3d_tpu_torch.data.lyftdb import LyftDB
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.pipelines import second_train as ttrain
from lyft3d_tpu_torch.pipelines.second_pipeline import LoaderConfig, SecondSampleLoader, create_infos
from lyft3d_tpu_torch.train import checkpoint as tckpt
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_second import port_config  # noqa: E402
from test_torch_second_train import JPILLARS as JCFG  # noqa: E402  no pillar overflows its cap
from test_torch_second_train import flat, pillars_batch, t  # noqa: E402

CFG = port_config(JCFG)


def adam(lr=1e-3):
    return lambda params: build_optimizer(params, "adam", lr)


def make_trainer(tmp_path, model=None, seed=0, **cfg):
    model = model or VoxelNet(CFG, generator=torch.Generator().manual_seed(seed))
    kw = dict(model_dir=str(tmp_path), total_steps=4, log_every=1, eval_every=0, ckpt_every=2)
    kw.update(cfg)
    return Trainer(model, adam(), ttrain.make_second_loss_fn(CFG), TrainerConfig(**kw))


def batches():
    batch = {k: t(v) for k, v in pillars_batch().items()}
    while True:
        yield batch


def test_two_trainer_steps_match_jax(tmp_path):
    batch = pillars_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, JCFG.grid, JCFG.max_voxels,
                                              JCFG.max_points_per_voxel))(jb["points"], jb["points_valid"])
    jmodel = JVoxelNet(JCFG, dtype=jnp.float32)
    variables = jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *[vox[k] for k in ("voxels", "num_points", "coords", "voxel_valid")])
    jtr = jtrainer.Trainer(jmodel, optax.adam(1e-3), jtrain.make_second_loss_fn(JCFG),
                           jtrainer.TrainerConfig(model_dir=str(tmp_path / "j"), donate_state=False))
    jstate = jtrainer.TrainState.create(variables, jtr.tx)

    model = load_flax_params(VoxelNet(CFG), jax.device_get(variables))
    ttr = make_trainer(tmp_path / "t", model)
    state = TrainState(model, adam())
    for step in range(2):
        jstate, jm = jtr._step_fn(jstate, jb, jax.random.PRNGKey(step))
        state, tm = ttr.step_fn(state, {k: t(v) for k, v in batch.items()})
        for k in ("loss", "cls_loss", "loc_loss", "dir_loss", "num_pos", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=f"step {step} {k}")
    assert state.step == int(jstate.step) == 2
    want, got = flat(jax.device_get(jstate.params)["params"]), flat(export_flax_params(model)["params"])
    start = flat(jax.device_get(variables)["params"])
    assert set(want) == set(got)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], atol=1e-5, rtol=0, err_msg="/".join(path))
        assert np.abs(want[path] - start[path]).max() > 1e-4, path  # every leaf moved


def test_fit_writes_artifacts_and_resume_restores_everything(tmp_path):
    trainer = make_trainer(tmp_path)
    state = trainer.fit(trainer.init_or_resume(), batches())
    assert state.step == 4
    reg = json.loads((tmp_path / "checkpoints.json").read_text())
    assert reg["latest"]["model"] == "model-4.ckpt"
    # Steps 2 and 4 periodically, 4 again at the end.
    assert reg["checkpoints"]["model"] == ["model-2.ckpt", "model-4.ckpt", "model-4.ckpt"]
    assert (tmp_path / "log.txt").exists()
    lines = [json.loads(l) for l in (tmp_path / "log.json.lst").read_text().splitlines()]
    assert [l["step"] for l in lines] == [1, 2, 3, 4]
    assert lines[-1]["train.loss"] < lines[0]["train.loss"] and "train.grad_norm" in lines[0]

    # A fresh trainer on another initialisation resumes the saved run.
    resumed = make_trainer(tmp_path, seed=9, total_steps=6)
    rstate = resumed.init_or_resume()
    assert rstate.step == 4
    for a, b in zip(rstate.module.state_dict().values(), state.module.state_dict().values()):
        assert torch.equal(a, b)
    assert rstate.optimizer.param_groups[0]["count"] == 4
    for p, q in zip(rstate.masters, state.masters):
        for slot in ("mu", "nu"):
            assert torch.equal(rstate.optimizer.state[p][slot], state.optimizer.state[q][slot])
    # One more step from the resumed state equals one more step of the original.
    batch = next(batches())
    resumed.step_fn(rstate, batch)
    trainer.step_fn(state, batch)
    for a, b in zip(rstate.module.parameters(), state.module.parameters()):
        assert torch.equal(a, b)
    assert "resumed from step 4" in (tmp_path / "log.txt").read_text()


def test_max_to_keep_prunes_and_registry_lists(tmp_path):
    trainer = make_trainer(tmp_path, total_steps=5, ckpt_every=1, max_to_keep=2)
    trainer.fit(trainer.init_or_resume(), batches())
    # The save at the end of fit registers step 5 a second time, as in the JAX
    # package: the registry keeps two entries, one file.
    assert sorted(p.name for p in tmp_path.glob("model-*.ckpt")) == ["model-5.ckpt"]
    assert [p.name for p in tckpt.list_checkpoints(tmp_path)] == ["model-5.ckpt", "model-5.ckpt"]
    assert tckpt.latest_checkpoint(tmp_path).name == "model-5.ckpt"
    assert tckpt.restore_latest(tmp_path / "nothing_here") == (None, None)
    sd, step = tckpt.restore_latest(tmp_path)
    assert step == 5 and sd["step"] == 5 and set(sd) == {"model", "masters", "optimizer", "step"}


def test_checkpoint_on_failure_then_reraise(tmp_path):
    trainer = make_trainer(tmp_path, total_steps=10, ckpt_every=0)

    def failing():
        gen = batches()
        for _ in range(3):
            yield next(gen)
        raise RuntimeError("the loader broke")

    state = trainer.init_or_resume()
    with pytest.raises(RuntimeError, match="the loader broke"):
        trainer.fit(state, failing())
    assert tckpt.latest_checkpoint(tmp_path).name == "model-3.ckpt"
    assert "interrupted at step 3" in (tmp_path / "log.txt").read_text()


def test_bfloat16_module_trains_through_float32_masters(tmp_path):
    model = VoxelNet(CFG, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    state = TrainState(model, adam(1e-4))
    kinds = {p.dtype for p in state.params}
    assert kinds == {torch.bfloat16, torch.float32}  # the heads stay float32
    assert all(m.dtype == torch.float32 for m in state.masters)
    own = [(p, m) for p, m in zip(state.params, state.masters) if m is not p]
    assert own and all(p.dtype == torch.bfloat16 for p, _ in own)
    trainer = make_trainer(tmp_path, model)
    # Updates far under one bfloat16 ulp of a weight accumulate in the masters.
    before = [m.detach().clone() for _, m in own]
    for _ in range(3):
        state, metrics = trainer.step_fn(state, next(batches()))
    assert torch.isfinite(metrics["loss"])
    assert any(not torch.equal(b, m.detach()) for b, (_, m) in zip(before, own))
    for p, m in own:
        assert torch.equal(p.detach(), m.detach().to(torch.bfloat16))
    sd = state.state_dict()
    assert len(sd["masters"]) == len(own)
    fresh = TrainState(VoxelNet(CFG, dtype=torch.bfloat16), adam(1e-4))
    fresh.load_state_dict(sd)
    for a, b in zip(fresh.masters, state.masters):
        assert torch.equal(a, b)


def test_partial_restore_and_repeat_eval(tmp_path):
    a = {"rpn.box.weight": torch.zeros(2, 3), "rpn.cls.weight": torch.zeros(4), "enc.w": torch.zeros(5)}
    donor = {"rpn.box.weight": torch.ones(2, 3), "rpn.cls.weight": torch.ones(7), "enc.w": torch.ones(5),
             "extra": torch.ones(1)}
    out = tckpt.partial_restore(a, donor, include=r"^rpn\.|^enc", exclude=r"enc")
    assert out["rpn.box.weight"].sum() == 6  # copied
    assert out["rpn.cls.weight"].sum() == 0  # shape differs
    assert out["enc.w"].sum() == 0 and set(out) == set(a)  # excluded; the donor's extra is ignored
    for step in (1, 2):
        tckpt.save(tmp_path, {"step": step}, global_step=step)
    seen = tckpt.repeat_eval_checkpoints(tmp_path, lambda path, step: tckpt.restore(path)["step"] * 10,
                                         poll_interval=0.0, max_idle_polls=1)
    assert seen == {1: 10, 2: 20}
    tckpt.save(tmp_path, {"step": 3}, global_step=3)
    again = tckpt.repeat_eval_checkpoints(tmp_path, lambda path, step: step, poll_interval=0.0,
                                          max_idle_polls=1)
    assert again == {3: 3}  # finished work is skipped after a restart


def test_train_second_on_the_synthetic_db(tmp_path):
    root = make_synthetic_lyft(tmp_path / "lyft", num_scenes=1, samples_per_scene=4,
                               classes=["car", "truck"], seed=2)
    db = LyftDB(root, root / "data")
    infos = create_infos(db, num_sweeps=1, classes=["car", "truck"])
    exp = SecondExperiment(
        point_cloud_range=(-40, -40, -3, 40, 40, 5), voxel_size=(1.0, 1.0, 8.0), max_voxels=1024,
        max_points_per_voxel=4,
        anchors=(
            AnchorConfig(class_name="car", size=(2.0, 4.8, 1.7), z_center=0.8,
                         matched_threshold=0.45, unmatched_threshold=0.3),
            AnchorConfig(class_name="truck", size=(2.8, 10.0, 3.4), z_center=1.7,
                         matched_threshold=0.45, unmatched_threshold=0.3),
        ),
        batch_size=2, num_sweeps=1,
        optimizer=OptimizerConfig(name="adam", lr=1e-3, grad_accum=1, total_steps=4, clip_norm=10.0),
        model_dir=str(tmp_path / "second_run"),
    )
    loader = SecondSampleLoader(db, infos, ["car", "truck"],
                                LoaderConfig(max_points=8192, num_sweeps=1, augment=True))
    vcfg = ttrain.voxelnet_config_from_experiment(
        exp, encoder_features=(16,), rpn_layer_nums=(1, 1), rpn_strides=(2, 2),
        rpn_filters=(16, 32), rpn_up_strides=(1, 2), rpn_up_filters=(16, 16))
    state, model, vcfg = ttrain.train_second(exp, loader, [i["token"] for i in infos], vcfg=vcfg,
                                            log_every=1, num_workers=2, dtype=torch.float32, device="cpu")
    run = tmp_path / "second_run"
    assert state.step == 4
    for name in ("experiment.yaml", "log.txt", "log.json.lst", "checkpoints.json", "model-4.ckpt"):
        assert (run / name).exists(), name
    assert all(np.isfinite(json.loads(l)["train.loss"]) for l in (run / "log.json.lst").read_text().splitlines())
    records = ttrain.evaluate_second(model, vcfg, loader, [infos[0]["token"]], ["car", "truck"], batch_size=2)
    assert isinstance(records, list) and not model.training
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (this machine has one; nothing to check)")
        ttrain.train_second(exp, loader, [i["token"] for i in infos], vcfg=vcfg)
