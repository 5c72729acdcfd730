"""Port parity of the multichip dry run (``lyft3d_tpu_torch/dryrun.py``)
against ``__graft_entry__.py::dryrun_multichip`` on two virtual devices:
the stages' configurations, stage 4 (the unit-sparse step) and stage 6 (the
RCNN step on fixed targets) on two gloo ranks with the JAX initialisation
carried over ``load_flax_params``, ``train_rcnn_online(n_devices=2)``
against the JAX online trainer, and ``dryrun_multichip(2, device="cpu")``
itself; then the ranks' placement on a shared card and the PointRCNN
trainers' check that every rank holds rank 0's weights.

Tolerances: losses 1e-5 relative; gradients 1e-5 of the largest gradient;
parameters after Adam's first step 1e-5 wherever JAX's gradient exceeds
100·eps (= 1e-6) and 2·lr everywhere (the step is ``lr·g/(|g| + eps)``, not
resolved where |g| is near eps: ROADMAP §C); the online trainer's
parameters within 2e-2 of how far they moved (``test_torch_pointrcnn_train.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.models.second.voxelnet import VoxelNetConfig as JConfig
from lyft3d_tpu.models.second.voxelnet import voxelnet_loss
from lyft3d_tpu.ops.anchors import AnchorSpec as JAnchorSpec
from lyft3d_tpu.ops.anchors import assign_targets
from lyft3d_tpu.ops.voxelize import VoxelGrid as JGrid
from lyft3d_tpu.ops.voxelize import voxelize
from lyft3d_tpu.parallel import mesh as jmesh
from lyft3d_tpu.pipelines import pointrcnn_train as jtrain
from lyft3d_tpu_torch import dryrun
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.parallel import mesh
from lyft3d_tpu_torch.pipelines import pointrcnn_train as ttrain
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_workers as workers  # noqa: E402  rank functions, no JAX
from test_torch_pointrcnn_train import (  # noqa: E402  the PointRCNN parity fixtures
    JCFG as PRC_JCFG,
    PADDED,
    TCFG as PRC_TCFG,
    check_moved,
    kitti_root,  # noqa: F401  a fixture
    loaders,
    rcnn_init,
    rpn_init,  # noqa: F401  a fixture
    stacked_draws,
    trained_rpn,  # noqa: F401  a fixture
)
from test_torch_second import port_config  # noqa: E402
from test_torch_second_train import flat  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
LR = 1e-3
ADAM_EPS = 1e-8

# The dry run's configurations, as __graft_entry__.py spells them.
ANCHOR = (JAnchorSpec(size=(2.0, 4.0, 1.6), z_center=0.0, matched_threshold=0.5, unmatched_threshold=0.35),)
JPILLARS = JConfig(
    grid=JGrid(point_cloud_range=(-16, -16, -3, 16, 16, 5), voxel_size=(1.0, 1.0, 8.0)),
    max_voxels=256, max_points_per_voxel=4, encoder="pillars", encoder_features=(16,), rpn_layer_nums=(1, 1),
    rpn_strides=(2, 2), rpn_filters=(16, 32), rpn_up_strides=(1, 2), rpn_up_filters=(16, 16), anchor_specs=ANCHOR)
JSPARSE = JConfig(
    grid=JGrid(point_cloud_range=(-8, -8, -2, 8, 8, 2), voxel_size=(0.5, 0.5, 1.0)),
    max_voxels=128, max_points_per_voxel=1, encoder="simple", middle="sparse_units", middle_z_slab=2,
    middle_features=(4, 8), middle_max_voxels=(128, 64), rpn_layer_nums=(1,), rpn_strides=(1,), rpn_filters=(16,),
    rpn_up_strides=(1,), rpn_up_filters=(16,), anchor_specs=ANCHOR)
JRPN = jnet.PointRCNNConfig(sa_npoints=(16, 8), sa_radii=((2.0,), (4.0,)), sa_nsamples=((8,), (8,)),
                            sa_widths=(8, 16), fp_width=8)
JRCNN = jnet.PointRCNNConfig(rcnn_sa_npoints=(8, 4), rcnn_widths=(8, 16), rcnn_sa_radii=(2.0, 4.0),
                             rcnn_sa_nsamples=(4, 4), roi_points=16)


def test_stage_configs_are_the_dry_runs():
    assert dryrun.pillars_config() == port_config(JPILLARS)
    assert dryrun.sparse_config() == port_config(JSPARSE)
    for got, want in ((dryrun.rpn_config(), JRPN), (dryrun.rcnn_config(), JRCNN)):
        assert repr(got).replace("lyft3d_tpu_torch.", "") == repr(want).replace("lyft3d_tpu.", "")


def _np(batch):
    return {k: _np(v) if isinstance(v, dict) else v.numpy() for k, v in batch.items()}


def jax_dp_step(model, params, loss_fn, batch):
    """One Adam step of ``loss_fn(params, batch)`` over a 2-device mesh, the
    batch sharded: (loss, gradients, parameters after the step)."""
    m = jmesh.make_mesh(RANKS)
    tx = optax.adam(LR)

    def step(params, opt_state, batch):
        loss, grads = jax.value_and_grad(loss_fn)(params, batch)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, grads

    out = jax.jit(step)(jmesh.replicate(m, params), jmesh.replicate(m, tx.init(params)), jmesh.shard_batch(m, batch))
    after, loss, grads = jax.device_get(out)
    return float(loss), grads, after


def jax_sparse_case(batch):
    """Stage 4 in JAX: the init of ``PRNGKey(3)`` and the step."""
    model = JVoxelNet(JSPARSE, dtype=jnp.float32)
    anchors, mt, ut, acls = JSPARSE.make_anchors()

    def vox(b):
        return jax.vmap(lambda p, v: voxelize(p, v, JSPARSE.grid, JSPARSE.max_voxels,
                                              JSPARSE.max_points_per_voxel))(b["points"], b["points_valid"])

    v0 = vox({k: jnp.asarray(v) for k, v in batch.items()})
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(3), v0["voxels"], v0["num_points"],
                                                v0["coords"], v0["voxel_valid"]))

    def loss_fn(p, b):
        v = vox(b)
        tgts = jax.vmap(lambda g, c, ok: assign_targets(anchors, acls, mt, ut, g, c, ok))(
            b["gt_boxes"], b["gt_classes"], b["gt_valid"])
        preds = model.apply(p, v["voxels"], v["num_points"], v["coords"], v["voxel_valid"])
        return voxelnet_loss(preds, tgts, JSPARSE)[0]

    return params, jax_dp_step(model, params, loss_fn, batch)


def jax_rcnn_case(batch):
    """Stage 6 in JAX: the targets of ``proposal_target_layer`` (``PRNGKey(0)``
    for every frame), the init of ``PRNGKey(5)`` and the step."""
    model = jnet.PointRCNN_RCNN(JRCNN)
    b, nroi = batch["rois"].shape[:2]
    tgts = jax.device_get(jax.vmap(lambda ro, g: jnet.proposal_target_layer(
        ro, jnp.ones((nroi,), bool), g, jnp.ones((2,), bool), JRCNN, jax.random.PRNGKey(0)))(
        jnp.asarray(batch["rois"]), jnp.asarray(batch["gt"])))
    batch = dict(batch, tgts={k: np.asarray(v) for k, v in tgts.items()})
    params = jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(5), jnp.zeros((nroi, dryrun.ROI_POINTS, 5)),
                                                jnp.full((nroi,), dryrun.ROI_POINTS, jnp.int32)))

    def loss_fn(p, bt):
        def one(rp, cn, ro, tg, g):
            return jnet.rcnn_loss(model.apply(p, rp, cn), ro, tg, g, JRCNN)[0]

        return jnp.mean(jax.vmap(one)(bt["roi_pts"], bt["counts"], bt["rois"], bt["tgts"], bt["gt"]))

    return params, batch, jax_dp_step(model, params, loss_fn, batch)


def _torch(batch):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def stages():
    """Stages 4 and 6 in JAX on two virtual devices and on two gloo ranks (one
    spawn), from the same initialisation and the dry run's inputs."""
    inputs = dryrun.dryrun_inputs(RANKS, 1)
    sparse_batch = _np(inputs["sparse"])
    sparse_params, sparse_jax = jax_sparse_case(sparse_batch)
    rcnn_params, rcnn_batch, rcnn_jax = jax_rcnn_case({k: v for k, v in _np(inputs["rcnn"]).items() if k != "tgts"})
    # The port's targets from the same draw hold the JAX layer's keys, dtypes and values.
    port_tgts = inputs["rcnn"]["tgts"]
    assert port_tgts.keys() == rcnn_batch["tgts"].keys()
    weights = {
        "sparse": load_flax_params(VoxelNet(dryrun.sparse_config(), in_features=4), sparse_params).state_dict(),
        "rcnn": load_flax_params(tnet.PointRCNN_RCNN(dryrun.rcnn_config(), 5), rcnn_params).state_dict(),
    }
    tgts = _torch(rcnn_batch["tgts"])
    tgts = {k: v.to(port_tgts[k].dtype) for k, v in tgts.items()}
    batches = {"sparse": inputs["sparse"], "rcnn": dict(inputs["rcnn"], tgts=tgts)}
    ranks = mesh.spawn(workers.run_jobs, RANKS, args=([
        (stage, "dryrun_stage", (stage, weights[stage], batches[stage])) for stage in ("sparse", "rcnn")],),
        device="cpu")
    return {"sparse": (sparse_params, sparse_jax, ranks["sparse"]), "rcnn": (rcnn_params, rcnn_jax, ranks["rcnn"])}


@pytest.mark.parametrize("stage", ["sparse", "rcnn"])
def test_stage_on_two_ranks_matches_jax_on_two_devices(stages, stage):
    """Stage 4 (the unit middle: fill, stencil and their backward sides on
    each rank's sample) and stage 6 (the RCNN on JAX's targets): loss,
    averaged gradients, parameters after the Adam step."""
    start, (jloss, jgrads, jafter), got = stages[stage]
    np.testing.assert_allclose(got["loss"], jloss, rtol=1e-5)
    jg, g = flat(jgrads["params"]), flat(got["grad_tree"])
    want, have, first = flat(jafter["params"]), flat(got["variables"]["params"]), flat(start["params"])
    assert set(jg) == set(g) == set(want) == set(have)
    scale = max(float(np.abs(v).max()) for v in jg.values())
    resolved = 0
    for path, w in want.items():
        name = "/".join(path)
        np.testing.assert_allclose(g[path], jg[path], atol=1e-5 * scale, rtol=0, err_msg=name)
        sure = np.abs(jg[path]) > 100 * ADAM_EPS
        resolved += int(sure.sum())
        np.testing.assert_allclose(have[path][sure], w[sure], atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(have[path], w, atol=2 * LR, rtol=0, err_msg=name)
    assert resolved > 0.5 * sum(w.size for w in want.values())
    assert any(np.abs(want[p] - first[p]).max() > 1e-4 for p in want)  # the step moved the weights
    assert got["agree"]


def test_train_rcnn_online_on_two_ranks_matches_jax_on_two_devices(kitti_root, trained_rpn):  # noqa: F811
    """Three steps of two frames, a frame a rank, with the JAX trainer's
    frame picks and its ``jax.random`` draws a frame (``PRNGKey(seed·7919 +
    step)`` split over the frames), each rank on its slice of them."""
    jparams_rpn, trpn = trained_rpn
    jl, tl = loaders(kitti_root, PADDED)
    steps, seed, batch = 3, 1, 2
    _, jparams, jlosses = jtrain.train_rcnn_online(jnet.PointRCNN_RPN(PRC_JCFG), jparams_rpn, jl, PRC_JCFG,
                                                   steps=steps, seed=seed, batch_size=batch, n_devices=RANKS)
    draws = [stacked_draws(jax.random.split(jax.random.PRNGKey(seed * 7919 + i), batch), PRC_JCFG.num_proposals,
                           PRC_JCFG.roi_fg_aug_times) for i in range(steps)]
    init = rcnn_init(seed, 3 + PRC_JCFG.fp_width)
    model = load_flax_params(tnet.PointRCNN_RCNN(PRC_TCFG, 3 + PRC_TCFG.fp_width), init)
    got, tlosses = ttrain.train_rcnn_online(trpn, tl, PRC_TCFG, steps=steps, seed=seed, batch_size=batch,
                                            num_workers=1, model=model, draws=draws.__getitem__, device="cpu",
                                            n_devices=RANKS)
    assert got is model
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, init)


def test_dryrun_multichip_on_two_cpu_ranks():
    """The whole dry run in a process of its own: every stage held to one
    process, the JAX dry run's lines and its last line."""
    proc = subprocess.run([sys.executable, "-m", "lyft3d_tpu_torch.dryrun", str(RANKS), "--device", "cpu"],
                          cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == ("dryrun_multichip stages ok (2 devices): ['unet DP', 'voxelnet pillars DP', "
                         "'voxelnet unit-sparse DP', 'pointrcnn rpn DP', 'pointrcnn rcnn DP']")
    heads = [line.split(" loss=")[0] for line in lines[:-1]]
    assert heads == [f"dryrun_multichip ok: {h} DP(2)" for h in
                     ("unet", "voxelnet", "voxelnet unit-sparse", "pointrcnn rpn", "pointrcnn rcnn")]


def test_dryrun_and_entry_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.entry()
    fn, (model, x) = dryrun.entry("cpu")
    assert x.shape == (1, 336, 336, 6) and sum(p.numel() for p in model.parameters()) > 4e7


@pytest.mark.parametrize("device, backend, want", [
    ("cuda", None, {"device": "cuda", "backend": None}),
    ("cuda", "gloo", {"device": "cuda:0", "backend": "gloo"}),
    ("cuda:1", "gloo", {"device": "cuda:1", "backend": "gloo"}),
    ("cpu", None, {"device": "cpu", "backend": None}),
    ("cpu", "gloo", {"device": "cpu", "backend": "gloo"}),
])
def test_rank_placement(device, backend, want):
    """A trainer's ranks: a card each over NCCL, or every gloo rank on the
    card ``device`` names."""
    assert mesh.rank_placement(device, backend) == want


def test_gloo_ranks_on_one_card_are_not_bounded_by_the_card_count():
    assert mesh.make_data_group(4, 2, device="cpu", backend="gloo") == 2
    if torch.cuda.is_available():
        assert mesh.make_data_group(4, 4, device="cuda:0", backend="gloo") == 4
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_data_group(4, 2, device="cuda:0", backend="gloo")


def test_pointrcnn_trainers_refuse_ranks_that_disagree():
    """A rank whose weights differ from rank 0's at the end of training makes
    every rank raise (``pointrcnn_train._from_rank``)."""
    got = mesh.spawn(workers.from_rank_check, RANKS, device="cpu")
    assert got == {"same": "returned", "differ": "the ranks' weights differ after training"}
