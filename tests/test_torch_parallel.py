"""Port parity of data parallelism (``lyft3d_tpu_torch/parallel/mesh.py``)
against the JAX package's ``n_devices`` runs on the conftest's virtual CPU
devices: the rank count and the shards, then two gloo ranks on the CPU for a
SECOND pillars step, a BatchNorm BEV step with class weights, the PointRCNN
RPN and offline RCNN trainers, ``train_second`` end to end, and the
point-sharded raster; and ``spawn``'s failure and refusal.

Each rank runs in a process of its own (``spawn``); the rank functions live
in ``tests/torch_parallel_workers.py``, which imports no JAX, and the JAX
references are computed here. A JAX step over a batch sharded on two
devices computes the global batch's function, so each 2-rank result is held
to it at the tolerance of the single-process parity test of the same
trainer: SECOND losses 1e-5 relative, gradients 1e-4 of each leaf's scale
against JAX's and the one-process port's (``test_torch_second_train.py``),
parameters after one Adam step 1e-5 absolute (``test_torch_trainer.py``)
wherever JAX's gradient lies outside that tolerance of 0 (Adam's first step
is ``lr·g/(|g| + ε)``, so an element whose gradient is zero up to rounding
may move either way within ``lr``); BEV
losses 1e-5 relative, the gradient norm 2e-2, parameters 2e-2 of how far
they moved, running statistics 1e-4 of their scale (``test_torch_bev_train.py``),
and the global BatchNorm statistics 1e-6 of their scale against the
one-process port at the global batch; PointRCNN losses 1e-5 relative and
parameters 2e-2 of how far they moved (``test_torch_pointrcnn_train.py``);
the raster exactly. After every step all ranks hold rank 0's weights bit for
bit.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lyft3d_tpu.config import BEVExperiment as JBEVExperiment
from lyft3d_tpu.config import OptimizerConfig as JOptimizerConfig
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.ops import voxelize as jvox
from lyft3d_tpu.ops.bev_raster import bev_rasterize_matmul
from lyft3d_tpu.parallel import mesh as jmesh
from lyft3d_tpu.pipelines import pointrcnn_train as jtrain
from lyft3d_tpu.pipelines import second_train as jsecond_train
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch.config import AnchorConfig, BEVExperiment, OptimizerConfig, SecondExperiment
from lyft3d_tpu_torch.data.lyftdb import LyftDB
from lyft3d_tpu_torch.models.layers import BatchNorm
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.parallel import mesh
from lyft3d_tpu_torch.pipelines import bev_train as tbev_train
from lyft3d_tpu_torch.pipelines import pointrcnn_train as ttrain
from lyft3d_tpu_torch.pipelines import second_train as tsecond_train
from lyft3d_tpu_torch.pipelines.second_pipeline import LoaderConfig, SecondSampleLoader, create_infos
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402  rank functions, no JAX
from test_second import make_cloud  # noqa: E402
from test_torch_bev_train import SMALL, bev_batch, jax_training_pieces  # noqa: E402
from test_torch_pointrcnn_train import (  # noqa: E402  the PointRCNN parity fixtures
    JCFG as PRC_JCFG,
    PADDED,
    SUBSAMPLED,
    TCFG as PRC_TCFG,
    check_moved,
    kitti_root,
    loaders,
    rcnn_init,
    rpn_init,
    torch_rpn,
    trained_rpn,
)
from test_torch_second import port_config  # noqa: E402
from test_torch_second_train import JPILLARS, flat  # noqa: E402

RANKS = 2


def jax_mesh(n=RANKS):
    return jmesh.make_mesh(n)


# ------------------------------------------------------------- rank count


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_make_data_group_follows_make_data_mesh(n_devices):
    """The largest divisor of the batch up to the device count, for batches
    1-12, as ``make_data_mesh`` sizes its ``data`` axis."""
    for batch in range(1, 13):
        want = jmesh.make_data_mesh(batch, n_devices).shape["data"]
        assert mesh.make_data_group(batch, n_devices, device="cpu") == want, (batch, n_devices)
    assert mesh.make_data_group(12, device="cpu") == 1  # the CPU's default: one rank


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_batch_takes_the_named_sharding_shards(n):
    rng = np.random.RandomState(n)
    batch = {"x": rng.rand(16, 3).astype(np.float32), "y": (rng.rand(16, 2, 2) > 0.5)}
    placed = jmesh.shard_batch(jax_mesh(n), batch)
    for key, arr in placed.items():
        shards = sorted(arr.addressable_shards, key=lambda s: s.index[0].start)
        assert len(shards) == n
        for rank, shard in enumerate(shards):
            group = mesh.DataGroup(size=n, rank=rank, device=torch.device("cpu"), backend="gloo")
            got = mesh.shard_batch(group, {k: torch.from_numpy(v) for k, v in batch.items()})[key]
            np.testing.assert_array_equal(got.numpy(), np.asarray(shard.data), err_msg=f"{key} rank {rank}")
    with pytest.raises(ValueError, match="does not split"):
        mesh.shard_batch(mesh.DataGroup(size=3, rank=0, device=torch.device("cpu"), backend="gloo"), batch)


def test_spawn_refuses_what_it_cannot_run():
    """No fallback: the card without a card, NCCL on the CPU, two NCCL ranks
    on one card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.spawn(workers.fails_on_rank_one, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_data_group(8)
    with pytest.raises(ValueError, match="gloo"):
        mesh.spawn(workers.fails_on_rank_one, 2, backend="nccl", device="cpu")


def test_a_rank_that_raises_fails_the_run():
    """Rank 1 raises while rank 0 waits at a barrier: ``spawn`` stops rank 0
    and raises with rank 1's traceback."""
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 raised first:(.|\n)*rank 1 cannot go on"):
        mesh.spawn(workers.fails_on_rank_one, RANKS, device="cpu")


# ---------------------------------------------- SECOND step and the raster


def second_batch():
    """Four pillars samples (no pillar overflows its cap), two boxes each."""
    gts = [[(2, 3, 0, 2, 4, 1.6, 0.3), (-5, -6, 0, 2, 4, 1.6, -0.7)], [(6, -4, 0, 2, 4, 1.6, 1.2)],
           [(-3, 5, 0, 2, 4, 1.6, 2.0)], [(4, 6, 0, 2, 4, 1.6, -1.4), (-6, 2, 0, 2, 4, 1.6, 0.1)]]
    clouds = [make_cloud(g, seed=10 + i) for i, g in enumerate(gts)]
    n = min(len(c) for c in clouds)
    boxes = np.zeros((4, 3, 7), np.float32)
    valid = np.zeros((4, 3), bool)
    for b, g in enumerate(gts):
        boxes[b, : len(g)] = g
        valid[b, : len(g)] = True
    return {"points": np.stack([c[:n] for c in clouds]), "points_valid": np.ones((4, n), bool),
            "gt_boxes": boxes, "gt_classes": np.ones((4, 3), np.int32), "gt_valid": valid}


RASTER = dict(shape=(64, 64, 3), voxel_size=(2.1, 2.1, 1.2), z_offset=-2.0)


def raster_cloud():
    rng = np.random.RandomState(3)
    n = RANKS * 2048
    pts = np.column_stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                           rng.uniform(-2.5, 0.5, n)]).astype(np.float32)
    pts[::97, :2] = 2.1 * np.round(pts[::97, :2] / 2.1)  # points on bin edges
    return pts, rng.rand(n) < 0.9


LINEAR_INIT = (np.ones((4, 3), np.float32), np.zeros(3, np.float32))


def linear_batch():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(16, 4).astype(np.float32), "y": rng.randn(16, 3).astype(np.float32)}


@pytest.fixture(scope="module")
def second_case(tmp_path_factory):
    """The JAX ``Trainer`` step over two devices and the port's over two
    ranks (and alone at the global batch), from one flax init; the raster
    in the same spawn."""
    tmp = tmp_path_factory.mktemp("second_dp")
    batch = second_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vox = jax.vmap(lambda p, m: jvox.voxelize(p, m, JPILLARS.grid, JPILLARS.max_voxels,
                                              JPILLARS.max_points_per_voxel))(jb["points"], jb["points_valid"])
    assert int(vox["num_points"].max()) < JPILLARS.max_points_per_voxel
    jmodel = JVoxelNet(JPILLARS, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), *[vox[k] for k in ("voxels", "num_points", "coords", "voxel_valid")]))
    jtr = jtrainer.Trainer(jmodel, optax.adam(1e-3), jsecond_train.make_second_loss_fn(JPILLARS),
                           jtrainer.TrainerConfig(model_dir=str(tmp / "j"), donate_state=False), mesh=jax_mesh())
    jstate = jtrainer.TrainState.create(variables, jtr.tx)
    sharded = jmesh.shard_batch(jtr.mesh, batch)
    jloss_fn = jsecond_train.make_second_loss_fn(JPILLARS)
    jgrads = jax.jit(jax.grad(lambda p, b: jloss_fn(jmodel, p, b, None)[0]))(variables, sharded)
    jstate, jm = jtr._step_fn(jstate, sharded, jax.random.PRNGKey(0))

    cfg = port_config(JPILLARS)
    in_features = batch["points"].shape[-1]
    model = load_flax_params(VoxelNet(cfg, in_features=in_features), variables)
    alone = Trainer(model, lambda p: build_optimizer(p, "adam", 1e-3), tsecond_train.make_second_loss_fn(cfg, "cpu"),
                    TrainerConfig(model_dir=str(tmp / "t")))
    state, _ = alone.step_fn(alone.init_or_resume(), {k: torch.from_numpy(v) for k, v in batch.items()})
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    alone_grads = {n: m.grad.numpy().copy() for n, m in zip(names, state.masters)}

    pts, valid = raster_cloud()
    ranks = mesh.spawn(workers.run_jobs, RANKS, args=([
        ("second", "second_step", (cfg, in_features, variables, batch, 1e-3)),
        ("raster", "raster", (pts, valid, RASTER)),
        ("linear", "linear_step", (*LINEAR_INIT, linear_batch(), 0.1)),
    ],), device="cpu")
    return {"jax": (jax.device_get(jstate.params), jm), "jax_grads": flat(jax.device_get(jgrads)["params"]),
            "alone_grads": alone_grads, "ranks": ranks, "raster": (pts, valid), "start": variables}


def gradient_tolerance(grads):
    """1e-4 of each leaf's scale, floored at 1e-3 of the largest leaf's."""
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {k: 1e-4 * max(float(np.abs(g).max()), 1e-3 * top) for k, g in grads.items()}


def test_second_step_on_two_ranks_matches_jax_on_two_devices(second_case):
    """Loss and metrics; the averaged gradients; the parameters after the
    Adam step: 1e-5 wherever JAX's gradient lies outside the gradient
    tolerance of 0. (Adam's first step is ``lr·g/(|g| + ε)``: an element
    whose gradient is zero up to rounding moves anywhere within ``lr``.)"""
    (jparams, jm), got = second_case["jax"], second_case["ranks"]["second"]
    for k in ("loss", "cls_loss", "loc_loss", "dir_loss", "num_pos", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-5, err_msg=k)
    jgrads, grads = second_case["jax_grads"], flat(got["grad_tree"])
    tol = gradient_tolerance(jgrads)
    want, have, start = flat(jparams["params"]), flat(got["variables"]["params"]), flat(second_case["start"]["params"])
    assert set(want) == set(have) == set(jgrads) == set(grads)
    held = 0
    for path in want:
        np.testing.assert_allclose(grads[path], jgrads[path], atol=tol[path], rtol=0, err_msg="/".join(path))
        sure = np.abs(jgrads[path]) > tol[path]
        held += int(sure.sum())
        np.testing.assert_allclose(have[path][sure], want[path][sure], atol=1e-5, rtol=0, err_msg="/".join(path))
        np.testing.assert_allclose(have[path], want[path], atol=2e-3, rtol=0, err_msg="/".join(path))
        assert np.abs(want[path] - start[path]).max() > 1e-4, path  # every leaf moved
    assert held > 0.9 * sum(w.size for w in want.values())
    assert got["agree"]


def test_second_master_gradients_after_the_all_reduce_equal_one_process(second_case):
    """The float32 master gradients each rank steps with, averaged over the
    ranks, against one process's at the global batch."""
    got, want = second_case["ranks"]["second"]["grads"], second_case["alone_grads"]
    assert got.keys() == want.keys()
    tol = gradient_tolerance(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol[name], err_msg=name)


def test_make_train_step_dp_matches_jax(second_case):
    """``tests/test_parallel.py``'s linear fit with SGD: the JAX
    ``make_train_step_dp`` over two devices and the port's over two ranks."""
    w, b = (jnp.asarray(a) for a in LINEAR_INIT)
    batch = linear_batch()

    def loss_fn(p, bt):
        return jnp.mean((bt["x"] @ p["w"] + p["b"] - bt["y"]) ** 2)

    tx = optax.sgd(0.1)
    params = {"w": w, "b": b}
    step = jmesh.make_train_step_dp(loss_fn, tx, jax_mesh())
    want, _, loss = step(jmesh.replicate(jax_mesh(), params), jmesh.replicate(jax_mesh(), tx.init(params)),
                         jmesh.shard_batch(jax_mesh(), batch))
    got = second_case["ranks"]["linear"]
    np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
    np.testing.assert_allclose(got["w"], np.asarray(want["w"]), rtol=1e-5)
    np.testing.assert_allclose(got["b"], np.asarray(want["b"]), rtol=1e-5, atol=1e-7)


def test_ranks_load_the_library_their_parent_built(tmp_path, monkeypatch):
    """``_build.load_library`` builds unless ``BUILD_DIR`` holds a library
    newer than every source of ``csrc/``."""
    import os

    from lyft3d_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    built = []
    monkeypatch.setattr(_build, "build", lambda name: built.append(name) or tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(_build, "_LIBS", {})
    lib = tmp_path / "libdense_fill.so"
    lib.write_bytes(b"")
    os.utime(lib, (0, 0))  # older than the sources: built again
    assert _build.load_library("dense_fill") == str(lib) and built == ["dense_fill"]
    monkeypatch.setattr(_build, "_LIBS", {})
    newest = max(f.stat().st_mtime for f in _build.CSRC_DIR.iterdir())
    os.utime(lib, (newest + 1, newest + 1))
    assert _build.load_library("dense_fill") == str(lib) and built == ["dense_fill"]  # loaded as it is


def test_point_sharded_raster_equals_jax_exactly(second_case):
    pts, valid = second_case["raster"]
    got = second_case["ranks"]["raster"]
    want = jmesh.bev_rasterize_point_sharded(jax_mesh(), jnp.asarray(pts), jnp.asarray(valid), **RASTER)
    np.testing.assert_array_equal(got["counts"], np.asarray(want))
    np.testing.assert_array_equal(got["counts"], np.asarray(bev_rasterize_matmul(pts, valid, **RASTER)))
    assert got["agree"] and got["counts"].sum() > 0


# ------------------------------------------------------------ the BEV step


@pytest.fixture(scope="module")
def bev_case(tmp_path_factory):
    """One step of ``adam`` with clipping on a BatchNorm UNet and class
    weights, global batch 4: JAX over two devices, the port over two ranks
    and alone. The second half of the batch is mostly background, so that
    the ranks' shares of ``Σ w`` differ."""
    tmp = tmp_path_factory.mktemp("bev_dp")
    opt = dict(name="adam", lr=1e-3, clip_norm=5.0, grad_accum=1, total_steps=1)
    common = dict(model="unet_reference", model_kwargs=SMALL, bev_shape=(32, 32, 3), batch_size=4)
    jexp = JBEVExperiment(**common, optimizer=JOptimizerConfig(**opt), model_dir=str(tmp / "j"))
    exp = BEVExperiment(**common, optimizer=OptimizerConfig(**opt), model_dir=str(tmp / "t"))
    with pytest.MonkeyPatch.context() as mp:
        pieces = jax_training_pieces(jexp, tmp, mp)
    batch = bev_batch(5, batch=4)
    batch["label"][2:, : 28] = 0
    jtr = jtrainer.Trainer(pieces["model"], pieces["tx"], pieces["loss_fn"],
                           jtrainer.TrainerConfig(model_dir=str(tmp / "jrun"), donate_state=False), mesh=jax_mesh())
    jstate = jtrainer.TrainState.create(pieces["params"], jtr.tx)
    jstate, jm = jtr._step_fn(jstate, jmesh.shard_batch(jtr.mesh, batch), jax.random.PRNGKey(0))

    model = load_flax_params(tbev_train.build_bev_model(exp, torch.float32, "cpu"), pieces["params"])
    alone = Trainer(model, tbev_train.make_bev_optimizer_fn(exp), tbev_train.make_bev_loss_fn(exp, "cpu"),
                    TrainerConfig(model_dir=str(tmp / "trun")))
    alone.step_fn(alone.init_or_resume(), {k: torch.from_numpy(v) for k, v in batch.items()})
    alone_stats = {name: tuple(s.numpy() for s in m.batch_stats)
                   for name, m in model.named_modules() if isinstance(m, BatchNorm)}
    got = mesh.spawn(workers.bev_step, RANKS, args=(exp, pieces["params"], batch), device="cpu")
    return {"jax": (jax.device_get(jstate.params), jm), "start": pieces["params"], "alone_stats": alone_stats,
            "ranks": got}


def test_bev_step_on_two_ranks_matches_jax_on_two_devices(bev_case):
    (jparams, jm), got = bev_case["jax"], bev_case["ranks"]
    for k in ("loss", "ce", "bce", "dice", "aux"):
        np.testing.assert_allclose(got["metrics"][k], float(jm[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["metrics"]["grad_norm"], float(jm["grad_norm"]), rtol=2e-2)
    have, start = flat(got["variables"]["params"]), flat(bev_case["start"]["params"])
    for path, want in flat(jparams["params"]).items():
        moved = np.abs(want - start[path]).max()
        assert moved > 1e-6, path
        np.testing.assert_allclose(have[path], want, atol=2e-2 * moved + 1e-6, rtol=0, err_msg="/".join(path))
    have_stats = flat(got["variables"]["batch_stats"])
    for path, want in flat(jparams["batch_stats"]).items():
        np.testing.assert_allclose(have_stats[path], want, rtol=0, err_msg="/".join(path),
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-6))
    assert got["agree"]


def test_bev_batch_norm_statistics_span_the_global_batch(bev_case):
    """Each BatchNorm's (mean, biased variance) of the 2-rank step against
    one process's at the global batch."""
    got, want = bev_case["ranks"]["batch_stats"], bev_case["alone_stats"]
    assert got.keys() == want.keys() and len(want) >= 4
    for name, (mean, var) in want.items():
        for g, w in zip(got[name], (mean, var)):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * max(1.0, float(np.abs(w).max())), err_msg=name)


@pytest.mark.parametrize("normaliser", ["global", "rank_local"])
def test_bev_cross_entropy_normaliser(bev_case, normaliser):
    """The CE's ``Σ w`` over the global batch gives JAX's CE; each rank's own
    ``Σ w`` (averaged over the ranks) gives another loss."""
    ce, want = bev_case["ranks"]["ce"][normaliser], float(bev_case["jax"][1]["ce"])
    if normaliser == "global":
        np.testing.assert_allclose(ce, want, rtol=1e-5)
    else:
        assert abs(ce - want) > 1e-3 * abs(want), (ce, want)


# ------------------------------------------------------------- PointRCNN


def test_rpn_trainer_on_two_ranks_matches_jax_on_two_devices(kitti_root, rpn_init):
    """Four RPN steps of two frames (one part, so every batch splits), the
    frames zero-padded (the loader draws nothing): losses and parameters.
    (Four: at ``total_steps=2`` the JAX ``adam_onecycle`` gives a NaN loss at
    the second step, with one device or two.)"""
    jl, tl = loaders(kitti_root, PADDED)
    kw = dict(steps=4, batch_size=2, num_parts=1, num_workers=1)
    _, jparams, jlosses = jtrain.train_pointrcnn_rpn(jl, PRC_JCFG, n_devices=RANKS, **kw)
    model = torch_rpn(rpn_init)
    got, tlosses = ttrain.train_pointrcnn_rpn(tl, PRC_TCFG, model=model, device="cpu", n_devices=RANKS, **kw)
    assert got is model and model.training
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, rpn_init)


@pytest.fixture(scope="module")
def offline_cache(kitti_root, trained_rpn):
    jparams_rpn, _ = trained_rpn
    jl, _ = loaders(kitti_root, SUBSAMPLED, seed=4)
    return jtrain.cache_rcnn_samples(jnet.PointRCNN_RPN(PRC_JCFG), jparams_rpn, jl, PRC_JCFG)


def test_offline_rcnn_trainer_on_two_ranks_matches_jax_on_two_devices(offline_cache):
    """Two offline steps of two frames with the JAX trainer's draw
    (``PRNGKey(0)`` at every step, the same for every frame)."""
    steps, seed, batch = 2, 2, 2
    _, jparams, jlosses = jtrain.train_rcnn_offline(offline_cache, PRC_JCFG, steps=steps, seed=seed,
                                                    batch_size=batch, n_devices=RANKS)
    fixed = [jax.random.uniform(k, (PRC_JCFG.num_proposals,)) for k in jax.random.split(jax.random.PRNGKey(0), 3)]
    draws = [tuple(torch.from_numpy(np.array(p)).expand(batch, -1) for p in fixed)] * steps
    init = rcnn_init(seed, 3 + PRC_JCFG.fp_width)
    model = load_flax_params(tnet.PointRCNN_RCNN(PRC_TCFG, 3 + PRC_TCFG.fp_width), init)
    cache = [{k: np.asarray(v) for k, v in c.items()} for c in offline_cache]
    _, tlosses = ttrain.train_rcnn_offline(cache, PRC_TCFG, steps=steps, seed=seed, batch_size=batch, model=model,
                                           draws=draws.__getitem__, device="cpu", n_devices=RANKS)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, init)


def test_offline_rcnn_ranks_take_their_slice_of_the_draws(offline_cache):
    """Draws that differ a frame: two ranks, each on its slice, train as one
    process on the global batch."""
    steps, seed, batch = 2, 3, 2
    gen = torch.Generator().manual_seed(7)
    draws = [tnet.draw_target_priorities((batch, PRC_TCFG.num_proposals), gen) for _ in range(steps)]
    cache = [{k: np.asarray(v) for k, v in c.items()} for c in offline_cache]
    init = rcnn_init(seed, 3 + PRC_JCFG.fp_width)
    models = [load_flax_params(tnet.PointRCNN_RCNN(PRC_TCFG, 3 + PRC_TCFG.fp_width), init) for _ in range(2)]
    _, alone = ttrain.train_rcnn_offline(cache, PRC_TCFG, steps=steps, seed=seed, batch_size=batch, model=models[0],
                                         draws=draws.__getitem__, device="cpu")
    _, ranks = ttrain.train_rcnn_offline(cache, PRC_TCFG, steps=steps, seed=seed, batch_size=batch, model=models[1],
                                         draws=draws.__getitem__, device="cpu", n_devices=RANKS)
    np.testing.assert_allclose(ranks, alone, rtol=1e-5)
    for (name, a), b in zip(models[0].state_dict().items(), models[1].state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=name)


# ------------------------------------------------------ train_second e2e


def test_train_second_on_two_ranks_equals_one_process(tmp_path):
    """``train_second(n_devices=2)`` on the synthetic DB (no augmentation,
    no subsampling: the loader draws nothing) against one process: the
    logged losses, the checkpoint the caller's state is restored from, and
    the weights."""
    root = make_synthetic_lyft(tmp_path / "lyft", num_scenes=1, samples_per_scene=4, classes=["car"], seed=2)
    db = LyftDB(root, root / "data")
    infos = create_infos(db, num_sweeps=1, classes=["car"])
    vcfg = None
    runs = {}
    for name, n in (("alone", None), ("ranks", RANKS)):
        exp = SecondExperiment(
            point_cloud_range=(-40, -40, -3, 40, 40, 5), voxel_size=(1.0, 1.0, 8.0), max_voxels=1024,
            max_points_per_voxel=64,
            anchors=(AnchorConfig(class_name="car", size=(2.0, 4.8, 1.7), z_center=0.8,
                                  matched_threshold=0.45, unmatched_threshold=0.3),),
            batch_size=2, num_sweeps=1,
            optimizer=OptimizerConfig(name="adam", lr=1e-3, grad_accum=1, total_steps=2, clip_norm=10.0),
            model_dir=str(tmp_path / name),
        )
        loader = SecondSampleLoader(db, infos, ["car"], LoaderConfig(max_points=1 << 16, num_sweeps=1, augment=False))
        vcfg = tsecond_train.voxelnet_config_from_experiment(
            exp, encoder_features=(16,), rpn_layer_nums=(1, 1), rpn_strides=(2, 2),
            rpn_filters=(16, 32), rpn_up_strides=(1, 2), rpn_up_filters=(16, 16))
        state, model, _ = tsecond_train.train_second(exp, loader, [i["token"] for i in infos], vcfg=vcfg,
                                                     n_devices=n, log_every=1, num_workers=1,
                                                     dtype=torch.float32, device="cpu")
        losses = [json.loads(l)["train.loss"] for l in (tmp_path / name / "log.json.lst").read_text().splitlines()
                  if "train.loss" in l]
        runs[name] = (state, model, losses)
    (s1, m1, l1), (s2, m2, l2) = runs["alone"], runs["ranks"]
    assert s1.step == s2.step == 2 and len(l1) == len(l2) == 2
    assert (tmp_path / "ranks" / "model-2.ckpt").exists()
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    for (name, a), b in zip(m1.state_dict().items(), m2.state_dict().values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-5, err_msg=name)
