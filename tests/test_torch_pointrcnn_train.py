"""Port parity of PointRCNN training on a KITTI tree exported from the
synthetic dataset, at the ``TINY`` config of the PointRCNN pipeline tests
(float32, CPU): one RPN step and one online RCNN step, the three trainers
end to end from the JAX package's initialisation, the offline cache,
``assemble_joint_params``, the CLI command in each mode, and the trainers'
refusal to run without a card unless asked for the CPU.

Tolerances: losses 1e-5 relative at every step; parameters after the run
within 2e-2 of how far they moved from the start (plus 1e-6), as the BEV
training parity holds them (a ReLU input within rounding of 0 takes its sign
from the order of a float32 sum); the cache's proposals 1e-4 (rotated IoU
in the NMS, ROADMAP §C) with equal validity, its point features 1e-5 of
scale. The RCNN trainers take their RoI-sampling and noise uniforms from a
``draws`` function; here it returns the numbers the JAX trainers draw with
``jax.random``, so that both sides sample the same RoIs. The frames of each
step are recorded on both sides and must be equal (the round-robin
schedule and the RCNN's picks)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lyft3d_tpu.data.kitti import export_kitti
from lyft3d_tpu.data.lyftdb import LyftDB
from lyft3d_tpu.data.synthetic import make_synthetic_lyft
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.ops.pointnet2 import roi_pool3d as jroi_pool3d
from lyft3d_tpu.pipelines import pointrcnn_train as jtrain
from lyft3d_tpu.train.optim import build_optimizer as jbuild_optimizer
from lyft3d_tpu_torch import cli
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.pipelines import pointrcnn as tpipe
from lyft3d_tpu_torch.pipelines import pointrcnn_train as ttrain
from lyft3d_tpu_torch.train.optim import build_optimizer
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

TINY = dict(
    sa_npoints=(128, 32), sa_radii=((1.5,), (3.0,)), sa_nsamples=((8,), (8,)),
    sa_widths=(16, 32), fp_width=16, num_proposals=8, nms_pre=64, roi_points=16,
    rcnn_sa_npoints=(8,), rcnn_widths=(16,), rois_per_image=8,
)
JCFG, TCFG = jnet.PointRCNNConfig(**TINY), tnet.PointRCNNConfig(**TINY)
# Fewer points than a cloud holds: the subsampler draws from the loader's
# generator. More: the cloud is zero-padded and the loader draws nothing,
# for the online trainer, whose JAX side assembles frames on four threads.
SUBSAMPLED, PADDED = 1024, 4608


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    root = make_synthetic_lyft(
        tmp_path_factory.mktemp("prcnn_train") / "lyft", num_scenes=1, samples_per_scene=3,
        boxes_per_sample=4, classes=["car"], seed=9, points_per_sweep=4096,
    )
    return export_kitti(LyftDB(root, root / "data"), tmp_path_factory.mktemp("prcnn_train") / "kitti")


def loaders(root, num_points, seed=0):
    kw = dict(num_points=num_points, classes=("car",))
    return (jtrain.KittiPointRCNNLoader(root, jtrain.KittiLoaderConfig(**kw), seed=seed),
            tpipe.KittiPointRCNNLoader(root, tpipe.KittiLoaderConfig(**kw), seed=seed))


def recording(loader):
    """Records the frames of every ``batch`` call of ``loader``."""
    seen, batch = [], loader.batch

    def wrapper(stems):
        seen.append(list(stems))
        return batch(stems)

    loader.batch = wrapper
    return seen


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def check_moved(got_model, want_params, start_params):
    got = flat(export_flax_params(got_model)["params"])
    start = flat(start_params["params"])
    moved_any = 0
    for path, want in flat(jax.device_get(want_params)["params"]).items():
        moved = float(np.abs(want - start[path]).max())
        moved_any += moved > 1e-6
        np.testing.assert_allclose(got[path], want, atol=2e-2 * moved + 1e-6, rtol=0, err_msg="/".join(path))
    assert moved_any >= len(start) // 2


@pytest.fixture(scope="module")
def rpn_init(kitti_root):
    """The JAX RPN's initialisation as ``train_pointrcnn_rpn`` makes it
    (``PRNGKey(0)`` at the loader's cloud size), from a loader of its own."""
    jl, _ = loaders(kitti_root, SUBSAMPLED)
    s = jl.sample(jl.stems[0])
    n = s["points"].shape[0]
    return jax.device_get(jax.jit(jnet.PointRCNN_RPN(JCFG).init)(
        jax.random.PRNGKey(0), jnp.asarray(s["points"]), jnp.zeros((n, 1)), jnp.asarray(s["points_valid"])))


def torch_rpn(params):
    return load_flax_params(tnet.PointRCNN_RPN(TCFG), params)


def test_rpn_step_matches_jax(kitti_root, rpn_init):
    """Two steps of ``make_rpn_step`` with ``adam_onecycle`` on one batch of
    two frames: loss and metrics, then the parameters."""
    jl, _ = loaders(kitti_root, SUBSAMPLED)
    batch = jl.batch(jl.stems[:2])
    tx = jbuild_optimizer("adam_onecycle", 2e-3, total_steps=10)
    jstep = jtrain.make_rpn_step(jnet.PointRCNN_RPN(JCFG), JCFG, tx)
    model = torch_rpn(rpn_init).train()
    tstep = ttrain.make_rpn_step(model, TCFG, build_optimizer(list(model.parameters()), "adam_onecycle", 2e-3,
                                                              total_steps=10))
    params, opt_state = rpn_init, tx.init(rpn_init)
    for step in range(2):
        params, opt_state, jloss, jmetrics = jstep(params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        tloss, tmetrics = tstep({k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, err_msg=f"step {step}")
        assert tmetrics.keys() == jmetrics.keys()
        for k, v in jmetrics.items():
            np.testing.assert_allclose(float(tmetrics[k]), float(v), rtol=1e-5, atol=1e-7, err_msg=k)
    check_moved(model, params, rpn_init)


def test_train_pointrcnn_rpn_matches_jax(kitti_root, rpn_init):
    """Six steps over two parts of three frames, batch 2 (the schedule
    wraps around the parts, a short part gives a one-frame batch)."""
    jl, tl = loaders(kitti_root, SUBSAMPLED)
    jseen, tseen = recording(jl), recording(tl)
    kw = dict(steps=6, batch_size=2, num_parts=2, num_workers=1)
    _, jparams, jlosses = jtrain.train_pointrcnn_rpn(jl, JCFG, **kw)
    model, tlosses = ttrain.train_pointrcnn_rpn(tl, TCFG, model=torch_rpn(rpn_init), device="cpu", **kw)
    assert tseen == jseen and len(tseen) == 7  # the init batch, then the schedule
    assert tseen[1:] == ttrain.rpn_schedule(tl.stems, 6, 2, 2, 0)
    assert {len(s) for s in tseen[1:]} == {1, 2}
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, rpn_init)


def jax_rcnn_draws(key, r, attempts):
    """The uniforms one frame of the JAX online trainer draws from ``key``:
    RoI-sampling priorities from ``k_tgt`` and RoI noise from ``k_noise``."""
    k_noise, k_tgt = jax.random.split(key)
    priorities = [jax.random.uniform(k, (r,)) for k in jax.random.split(k_tgt, 3)]
    k_keep, k_loc, k_size, k_yaw = jax.random.split(k_noise, 4)
    yaw = float(jnp.pi) / 12
    noise = {"keep": jax.random.uniform(k_keep, (r, attempts)),
             "loc": jax.random.uniform(k_loc, (r, attempts, 3), minval=-0.5, maxval=0.5),
             "size": jax.random.uniform(k_size, (r, attempts, 3), minval=-0.15, maxval=0.15),
             "yaw": jax.random.uniform(k_yaw, (r, attempts), minval=-yaw, maxval=yaw)}
    return priorities, noise


def stacked_draws(keys, r, attempts):
    """``(priorities, noise)`` of the frames of ``keys`` as the port takes them."""
    frames = [jax_rcnn_draws(k, r, attempts) for k in keys]
    priorities = tuple(torch.stack([torch.from_numpy(np.array(f[0][i])) for f in frames]) for i in range(3))
    noise = {k: torch.stack([torch.from_numpy(np.array(f[1][k])) for f in frames]) for k in frames[0][1]}
    return priorities, noise


def rcnn_init(seed, in_features):
    """The JAX RCNN's initialisation as the RCNN trainers make it."""
    r, p = JCFG.num_proposals, JCFG.roi_points
    return jax.device_get(jax.jit(jnet.PointRCNN_RCNN(JCFG).init)(
        jax.random.PRNGKey(seed), jnp.zeros((r, p, in_features)), jnp.zeros((r,), jnp.int32)))


def test_online_rcnn_step_matches_jax():
    """One step of the online RCNN after stage 1, on RoIs around the GT
    boxes (so that some are foreground and RoI noise has work): RoI
    sampling, RoI noise, RoI pool and canonical frame, the RCNN, its loss
    and an ``adam`` update."""
    rng = np.random.RandomState(3)
    r, c = JCFG.num_proposals, JCFG.fp_width
    gt = np.zeros((6, 7), np.float32)
    gt[:4] = np.column_stack([rng.uniform(-8, 8, (4, 2)), np.full(4, -1.0), np.tile([1.9, 4.7, 1.7], (4, 1)),
                              rng.uniform(-3, 3, 4)])
    gt_valid = np.arange(6) < 4
    rois = np.repeat(gt[:4], 2, 0) + rng.uniform(-0.3, 0.3, (r, 7)) * [1, 1, 0.2, 0.1, 0.2, 0.1, 0.3]
    rois[6:, :2] += 5.0  # two background RoIs
    rois = rois.astype(np.float32)
    xyz = np.concatenate([np.repeat(gt[:4, :3], 60, 0) + rng.uniform(-2, 2, (240, 3)) * [1, 1, 0.4],
                          rng.uniform(-12, 12, (272, 3)) * [1, 1, 0.1]]).astype(np.float32)
    feats = rng.randn(len(xyz), c).astype(np.float32)
    valid = np.ones(len(xyz), bool)
    roi_valid = np.ones(r, bool)
    key = jax.random.PRNGKey(7)
    init = rcnn_init(0, 3 + c)
    rcnn = jnet.PointRCNN_RCNN(JCFG)
    tx = optax.adam(1e-3)

    @jax.jit
    def jax_step(params, key, rois, roi_valid, gt, gt_valid, xyz, feats, valid):
        k_noise, k_tgt = jax.random.split(key)
        tgts = jnet.proposal_target_layer(rois, roi_valid, gt, gt_valid, JCFG, k_tgt)
        noisy = jnet.aug_rois_with_noise(rois, k_noise, gt_of_rois=gt[tgts["assigned_gt"]],
                                         fg=tgts["fg"], pos_iou=JCFG.fg_iou, attempts=JCFG.roi_fg_aug_times)
        pooled, counts, _ = jroi_pool3d(xyz, feats, valid, noisy, num_sampled=JCFG.roi_points,
                                        extra_width=JCFG.roi_extra_width)
        pts = jnp.concatenate([jnet.canonical_transform(pooled[..., :3], noisy), pooled[..., 3:]], -1)

        def lf(p):
            return jnet.rcnn_loss(rcnn.apply(p, pts, counts), noisy, tgts, gt, JCFG)[0]

        loss, grads = jax.value_and_grad(lf)(params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return optax.apply_updates(params, updates), loss, tgts

    jparams, jloss, jtgts = jax.device_get(jax_step(init, key, rois, roi_valid, gt, gt_valid, xyz, feats, valid))
    assert jtgts["fg"].sum() >= 2 and (jtgts["keep"] & ~jtgts["fg"]).sum() >= 1

    model = load_flax_params(tnet.PointRCNN_RCNN(TCFG, 3 + c), init).train()
    optimizer = build_optimizer(list(model.parameters()), "adam", 1e-3)
    priorities, noise = stacked_draws([key], r, JCFG.roi_fg_aug_times)
    T = {k: torch.from_numpy(v)[None] for k, v in dict(rois=rois, roi_valid=roi_valid, gt=gt, gt_valid=gt_valid,
                                                        xyz=xyz, feats=feats, valid=valid).items()}
    tgts = tnet.proposal_target_layer(T["rois"], T["roi_valid"], T["gt"], T["gt_valid"], TCFG, priorities)
    for k in ("assigned_gt", "fg", "keep"):
        np.testing.assert_array_equal(tgts[k][0].numpy(), jtgts[k], err_msg=k)
    noisy = tnet.aug_rois_with_noise(T["rois"], noise, gt_of_rois=tnet.gather_boxes(T["gt"], tgts["assigned_gt"]),
                                     fg=tgts["fg"], pos_iou=TCFG.fg_iou)
    pts, counts = ttrain.rcnn_inputs(T["xyz"], T["feats"], T["valid"], noisy, TCFG)
    loss = ttrain.rcnn_step(model, optimizer, pts, counts, noisy, tgts, T["gt"], TCFG)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    check_moved(model, jparams, init)


@pytest.fixture(scope="module")
def trained_rpn(kitti_root, rpn_init):
    """A JAX RPN moved off its initialisation (RPN scores that pass the
    proposal layer), and the same weights in the port."""
    rng = np.random.RandomState(2)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.05 * rng.randn(*a.shape).astype(np.float32),
                                    rpn_init)
    return params, torch_rpn(params)


def test_train_rcnn_online_matches_jax(kitti_root, trained_rpn):
    """Three steps of one frame: the JAX trainer's frame picks and its
    ``jax.random`` draws for each step (``PRNGKey(seed·7919 + step)``, split
    a frame), fed to the port through ``draws``."""
    jparams_rpn, trpn = trained_rpn
    jl, tl = loaders(kitti_root, PADDED)
    jseen, tseen = recording(jl), recording(tl)
    steps, seed = 3, 1
    _, jparams, jlosses = jtrain.train_rcnn_online(jnet.PointRCNN_RPN(JCFG), jparams_rpn, jl, JCFG,
                                                   steps=steps, seed=seed)

    def draws(step):
        keys = jax.random.split(jax.random.PRNGKey(seed * 7919 + step), 1)
        return stacked_draws(keys, JCFG.num_proposals, JCFG.roi_fg_aug_times)

    init = rcnn_init(seed, 3 + JCFG.fp_width)
    model = load_flax_params(tnet.PointRCNN_RCNN(TCFG, 3 + TCFG.fp_width), init)
    got, tlosses = ttrain.train_rcnn_online(trpn, tl, TCFG, steps=steps, seed=seed, num_workers=1,
                                            model=model, draws=draws, device="cpu")
    assert got is model and not trpn.training
    assert tseen == jseen and len(tseen) == steps
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, init)


def test_cache_and_train_rcnn_offline_match_jax(kitti_root, trained_rpn):
    """The frozen RPN's cache a frame, then three offline steps of two
    frames each on the JAX cache, with the JAX trainer's draw
    (``PRNGKey(0)`` at every step, the same for every frame)."""
    jparams_rpn, trpn = trained_rpn
    jl, tl = loaders(kitti_root, SUBSAMPLED, seed=4)
    jcache = jtrain.cache_rcnn_samples(jnet.PointRCNN_RPN(JCFG), jparams_rpn, jl, JCFG)
    tcache = ttrain.cache_rcnn_samples(trpn, tl, TCFG)
    assert [c["stem"] for c in tcache] == [c["stem"] for c in jcache] == tl.stems
    valid_rois = 0
    for got, want in zip(tcache, jcache):
        assert got.keys() == want.keys()
        for k in ("xyz", "points_valid", "gt_boxes", "gt_valid", "roi_valid"):
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        ok = np.asarray(want["roi_valid"])
        valid_rois += int(ok.sum())
        np.testing.assert_allclose(got["rois"][ok], np.asarray(want["rois"])[ok], rtol=0, atol=1e-4)
        feats = np.asarray(want["point_features"])
        np.testing.assert_allclose(got["point_features"], feats, rtol=0, atol=1e-5 * np.abs(feats).max())
    assert valid_rois > 0

    steps, seed, batch = 3, 2, 2
    _, jparams, jlosses = jtrain.train_rcnn_offline(jcache, JCFG, steps=steps, seed=seed, batch_size=batch)
    # The JAX trainer hands PRNGKey(0) itself to proposal_target_layer.
    fixed = [jax.random.uniform(k, (JCFG.num_proposals,)) for k in jax.random.split(jax.random.PRNGKey(0), 3)]
    draws = [tuple(torch.from_numpy(np.array(p)).expand(batch, -1) for p in fixed)] * steps
    init = rcnn_init(seed, 3 + JCFG.fp_width)
    model = load_flax_params(tnet.PointRCNN_RCNN(TCFG, 3 + TCFG.fp_width), init)
    cache = [{k: np.asarray(v) for k, v in c.items()} for c in jcache]
    _, tlosses = ttrain.train_rcnn_offline(cache, TCFG, steps=steps, seed=seed, batch_size=batch, model=model,
                                           draws=draws.__getitem__, device="cpu")
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    check_moved(model, jparams, init)


def test_offline_default_draw_is_fixed(kitti_root, trained_rpn, monkeypatch):
    """Without ``draws`` the offline trainer samples RoIs from the same
    numbers at every step (a generator seeded 0 anew), for every frame."""
    _, trpn = trained_rpn
    _, tl = loaders(kitti_root, SUBSAMPLED)
    cache = ttrain.cache_rcnn_samples(trpn, tl, TCFG, stems=tl.stems[:2])
    seen = []
    layer = ttrain.proposal_target_layer

    def spy(*args):
        seen.append(args[-1])
        return layer(*args)

    monkeypatch.setattr(ttrain, "proposal_target_layer", spy)
    _, losses = ttrain.train_rcnn_offline(cache, TCFG, steps=3, batch_size=2, device="cpu")
    assert len(losses) == 3 and np.isfinite(losses).all() and len(seen) == 3
    for priorities in seen:
        for p, first in zip(priorities, seen[0]):
            assert p.shape == (2, TCFG.num_proposals) and torch.equal(p, first) and torch.equal(p[0], p[1])


def test_assemble_joint_params_matches_jax(kitti_root, trained_rpn):
    jparams_rpn, trpn = trained_rpn
    rcnn_params = rcnn_init(5, 3 + JCFG.fp_width)
    jl, _ = loaders(kitti_root, SUBSAMPLED)
    s = jl.sample(jl.stems[0])
    want = jtrain.assemble_joint_params(jnet.PointRCNN(JCFG), jparams_rpn, rcnn_params,
                                        (jnp.asarray(s["points"]), jnp.asarray(s["points_valid"])))
    trcnn = load_flax_params(tnet.PointRCNN_RCNN(TCFG, 3 + TCFG.fp_width), rcnn_params)
    joint = tnet.PointRCNN(TCFG, generator=torch.Generator().manual_seed(9))
    assert ttrain.assemble_joint_params(joint, trpn, trcnn) is joint
    got = flat(export_flax_params(joint)["params"])
    want = flat(jax.device_get(want)["params"])
    assert got.keys() == want.keys()
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg="/".join(path))


@pytest.mark.parametrize("mode", ["rpn", "rcnn", "rcnn_offline"])
def test_cli_train_pointrcnn(kitti_root, mode, capsys):
    """``train-pointrcnn --device cpu --preset tiny`` in each mode."""
    cli.main(["train-pointrcnn", "--kitti-root", str(kitti_root), "--num-points", "1024", "--steps", "2",
              "--batch-size", "1", "--mode", mode, "--rcnn-steps", "1", "--preset", "tiny", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines] == ["final rpn loss"] + (["final rcnn loss"] if mode != "rpn" else [])
    assert all(np.isfinite(float(line.split(":")[1])) for line in lines)


TRAINERS = {
    "train_pointrcnn_rpn": lambda tl, rpn: ttrain.train_pointrcnn_rpn(tl, TCFG, steps=1),
    "train_rcnn_online": lambda tl, rpn: ttrain.train_rcnn_online(rpn, tl, TCFG, steps=1),
    "train_rcnn_offline": lambda tl, rpn: ttrain.train_rcnn_offline([{"point_features": np.zeros((4, 16))}],
                                                                    TCFG, steps=1),
}


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_trainers_take_the_card_by_default(kitti_root, trained_rpn, name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tl = loaders(kitti_root, SUBSAMPLED)
    with pytest.raises(RuntimeError, match=f"{name}: no CUDA device found"):
        TRAINERS[name](tl, trained_rpn[1])
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["train-pointrcnn", "--kitti-root", str(kitti_root)])
