"""Port parity of tensor parallelism (``lyft3d_tpu_torch/parallel/tensor.py``
and the ``(data, model)`` mesh of ``parallel/mesh.py``) against the JAX
package's ``make_mesh``, ``make_data_mesh`` and ``tensor_parallel_params`` on
the conftest's virtual CPU devices; and the last small public names of the
JAX API (``register_backbone``, ``lookup``, ``subm_conv3d_gather``).

- The mesh shapes equal the JAX meshes' for every rank count and model axis.
- The port selects the flax leaves the JAX rule shards, on every registered
  model, the pillars, FHD and per-voxel ``VoxelNet`` configurations of the
  yamls and PointRCNN at the Lyft preset, at full width: the JAX side gets
  stand-ins of shape ``(1, …, 1, out)`` built from ``jax.eval_shape`` (its
  rule reads only the key, ``ndim`` and ``shape[-1]``), the port's module
  is built on the ``meta`` device and its weights mapped to flax leaves by
  the bridge.
- Four gloo ranks on the CPU, ``2 x 2`` (data 2, model 2), spawned once for
  the module: the dry run's ``TPConvStack`` Adam step against the JAX step
  on a ``(2, 2)`` mesh (loss 1e-5 relative, parameters 1e-5 absolute); each
  column-parallel layer type against itself unsharded (output, input
  gradient and weight gradient within 1e-6 of their scale, float32 sums in
  another order); a clipped ``ranger`` update of a narrow
  ``unet_seresnext26`` against one process (the update within 1e-4 of its
  size), where a rank-local clip norm misses by more than 1e-2; a
  ``Trainer.fit`` of the bfloat16 stack (float32 masters, ``ranger``),
  evaluated and checkpointed every step, whose checkpoint is the whole
  model (one process's within the bfloat16 gradients' rounding) and
  resumes bit for bit into another module's slices.

The rank functions live in ``tests/torch_tensor_parallel_workers.py``, which
imports no JAX.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from lyft3d_tpu.config import SecondExperiment, load_yaml
from lyft3d_tpu.models import backbones as jbackbones
from lyft3d_tpu.models.pointrcnn import net as jnet
from lyft3d_tpu.models.registry import build_model as jax_build_model
from lyft3d_tpu.models.registry import list_models as jax_list_models
from lyft3d_tpu.models.second.voxelnet import VoxelNet as JVoxelNet
from lyft3d_tpu.ops import sparse_conv as jsc
from lyft3d_tpu.parallel import mesh as jmesh
from lyft3d_tpu.pipelines import second_train as jsecond
from lyft3d_tpu_torch.models import backbones as tbackbones
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models.pointrcnn import net as tnet
from lyft3d_tpu_torch.models.second.voxelnet import VoxelNet
from lyft3d_tpu_torch.ops import sparse_conv as tsc
from lyft3d_tpu_torch.parallel import mesh
from lyft3d_tpu_torch.parallel.tensor import tensor_parallel_selection
from lyft3d_tpu_torch.pipelines import second as tsecond
from lyft3d_tpu_torch.utils.flax_params import flax_leaves

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_tensor_parallel_workers as workers  # noqa: E402  rank functions, no JAX
from lyft3d_tpu_torch.train import checkpoint as ckpt  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MODEL_PARALLEL = 2
DATA = 2
CLIP_NORM = 5.0  # the BEV yaml's; the narrow UNet's gradient norm here is about 11.6, so it clips


# ------------------------------------------------------------------ the mesh


@pytest.mark.parametrize("n,m", [(n, m) for n in range(1, 9) for m in range(1, n + 1) if n % m == 0])
def test_make_mesh_shape_follows_jax(n, m):
    want = jmesh.make_mesh(n, model_parallel=m)
    got = mesh.make_mesh(n, m, device="cpu")
    assert got.shape == dict(want.shape)
    # Rank r at (d, m) = divmod(r, M), as the JAX mesh lays its devices out.
    ids = np.vectorize(lambda d: d.id)(want.devices)
    np.testing.assert_array_equal(got.devices, ids)


@pytest.mark.parametrize("batch", [1, 4, 6, 7, 12])
def test_make_data_mesh_follows_jax(batch):
    for n in range(1, 9):
        assert mesh.make_data_mesh(batch, n, device="cpu").shape == dict(jmesh.make_data_mesh(batch, n).shape)


def test_rank_functions_import_no_jax():
    """The ranks import the workers module (``spawn`` pickles its functions
    by name): it must not bring in JAX."""
    code = ("import sys; sys.path.insert(0, 'tests'); import torch_tensor_parallel_workers; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'lyft3d_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO)},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_uneven_model_axis_is_refused():
    with pytest.raises(ValueError):
        mesh.make_mesh(6, 4, device="cpu")
    with pytest.raises(ValueError):
        mesh.spawn(workers.run_jobs, 6, args=([],), device="cpu", model_parallel=4)


# ------------------------------------------------------------- the selection


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_selected(variables, min_features):
    """Flax paths the JAX ``tensor_parallel_params`` shards on a ``(1, 2)``
    mesh, fed stand-ins of shape ``(1, …, 1, shape[-1])``."""
    stand_ins = jax.tree_util.tree_map(
        lambda s: np.zeros((1,) * (len(s.shape) - 1) + tuple(s.shape[-1:]), np.float32), variables["params"])
    placed = jmesh.tensor_parallel_params(jmesh.make_mesh(MODEL_PARALLEL, model_parallel=MODEL_PARALLEL),
                                          stand_ins, min_features=min_features)
    return {("params",) + path for path, x in _flat(placed) if "model" in tuple(x.sharding.spec)}


def port_selected(module, min_features):
    leaves = flax_leaves(module)
    chosen = tensor_parallel_selection(module, MODEL_PARALLEL, min_features)
    return {(leaves[name][0],) + leaves[name][1] for name in chosen}


def _shape(*shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _bev(name):
    jm = jax_build_model(name, n_classes=10, dtype=jnp.float32)
    return (jax.eval_shape(jm.init, jax.random.PRNGKey(0), _shape(1, 64, 64, 6)),
            build_model(name, n_classes=10, device="meta"))


def _voxelnet(yaml, in_features, **changes):
    exp = load_yaml(SecondExperiment, REPO / "configs" / yaml)
    jcfg = dataclasses.replace(jsecond.voxelnet_config_from_experiment(exp), **changes)
    tcfg = dataclasses.replace(tsecond.voxelnet_config_from_experiment(exp), **changes)
    v, p = jcfg.max_voxels, jcfg.max_points_per_voxel
    shapes = jax.eval_shape(JVoxelNet(jcfg, dtype=jnp.float32).init, jax.random.PRNGKey(0),
                            _shape(1, v, p, in_features), _shape(1, v, dtype=jnp.int32),
                            _shape(1, v, 3, dtype=jnp.int32), _shape(1, v, dtype=jnp.bool_))
    return shapes, VoxelNet(tcfg, in_features=in_features, device="meta")


def _pointrcnn():
    n = 16384  # the preset's input cloud (the parameters do not depend on it)
    shapes = jax.eval_shape(lambda k, x, v: jnet.PointRCNN(jnet.lyft_pointrcnn_config("train")).init(k, x, None, v),
                            jax.random.PRNGKey(0), _shape(n, 3), _shape(n, dtype=jnp.bool_))
    return shapes, tnet.PointRCNN(tnet.lyft_pointrcnn_config("train"), device="meta")


SELECTION_CASES = {
    **{name: (lambda name=name: _bev(name)) for name in jax_list_models()},
    "voxelnet_pillars": lambda: _voxelnet("second_lyft_9class.yaml", 4),
    "voxelnet_fhd_units": lambda: _voxelnet("second_lyft_9class_sparse.yaml", 3),
    "voxelnet_fhd_per_voxel": lambda: _voxelnet("second_lyft_9class_sparse.yaml", 3, middle="sparse"),
    "voxelnet_fhd_columns": lambda: _voxelnet("second_lyft_9class_sparse.yaml", 3, middle="sparse_columns"),
    "pointrcnn_lyft_train": _pointrcnn,
}


@pytest.mark.parametrize("case", sorted(SELECTION_CASES))
def test_port_shards_the_leaves_jax_shards(case):
    """At full width, for ``min_features`` 128 and 256 on a model axis of 2:
    the same set of flax leaves, and some are sharded."""
    variables, module = SELECTION_CASES[case]()
    for min_features in (128, 256):
        want = jax_selected(variables, min_features)
        assert port_selected(module, min_features) == want, (case, min_features)
        assert want or min_features == 256, case  # 128-wide layers exist in every model


# -------------------------------------------------- four gloo ranks, 2 x 2


class TPConvStack(fnn.Module):
    """The multichip dry run's TP stage model."""

    features: int = 128
    n_out: int = 10

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(self.features, (3, 3))(x))
        x = fnn.relu(fnn.Conv(self.features, (3, 3))(x))
        return fnn.Conv(self.n_out, (1, 1))(x)


def stack_to_torch(params):
    """flax ``Conv_i`` → ``nn.Sequential`` indices 0, 2, 4 (HWIO → OIHW)."""
    out = {}
    for i, seq in enumerate((0, 2, 4)):
        conv = params["params"][f"Conv_{i}"]
        out[f"{seq}.weight"] = np.ascontiguousarray(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        out[f"{seq}.bias"] = np.asarray(conv["bias"])
    return out


def graft_batch():
    rng = np.random.RandomState(0)
    return {"image": rng.rand(2 * DATA, 16, 16, 6).astype(np.float32),
            "label": (rng.rand(2 * DATA, 16, 16) * 10).astype(np.int32)}


def jax_graft_step(batch):
    """The dry run's TP step on a ``(2, 2)`` mesh of virtual devices, the
    batch an argument of the jitted step: the initial parameters, those after
    the step, the loss, the sharded leaves and the step's gradients."""
    model = TPConvStack()
    tp_mesh = jmesh.make_mesh(DATA * MODEL_PARALLEL, model_parallel=MODEL_PARALLEL)
    params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 6), jnp.float32))
    start = jax.device_get(params)
    params = jmesh.tensor_parallel_params(tp_mesh, params, min_features=128)
    tx = optax.adam(1e-3)
    opt = jmesh.replicate(tp_mesh, tx.init(jax.tree_util.tree_map(np.asarray, params)))

    def step(params, opt_state, batch):
        def loss_fn(p):
            logits = model.apply(p, batch["image"])
            onehot = jax.nn.one_hot(batch["label"], 10)
            return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, grads

    sharded = {"/".join(p) for p, x in _flat(params) if "model" in tuple(x.sharding.spec)}
    params, _, loss, grads = jax.jit(step)(params, opt, jmesh.shard_batch(tp_mesh, batch))
    return start, jax.device_get(params), float(loss), sharded, jax.device_get(grads)


def unet_batch():
    rng = np.random.RandomState(3)
    label = rng.randint(0, 10, (2 * DATA, 32, 32)).astype(np.int32)
    label[:, :16] = 0
    return {"image": rng.rand(2 * DATA, 32, 32, 6).astype(np.float32), "label": label}


@pytest.fixture(scope="module")
def jax_graft():
    return jax_graft_step(graft_batch())


def trainer_case():
    """(weights, other weights, two batches) of the ``Trainer`` round trip."""
    other = workers.tp_conv_stack(generator=torch.Generator().manual_seed(5)).state_dict()
    rng = np.random.RandomState(4)
    second = {"image": rng.rand(2 * DATA, 16, 16, 6).astype(np.float32),
              "label": (rng.rand(2 * DATA, 16, 16) * 10).astype(np.int32)}
    return {k: v.numpy() for k, v in other.items()}, [graft_batch(), second]


@pytest.fixture(scope="module", autouse=True)
def spawned(jax_graft, tmp_path_factory):
    """One spawn of four ranks (data 2 x model 2) for every check below,
    started with the module so that the ranks work while the selection
    checks trace their models."""
    jobs = [("layers", "layer_cases", ()),
            ("graft", "graft_step", (stack_to_torch(jax_graft[0]), graft_batch())),
            ("ranger", "clipped_ranger", (unet_batch(), CLIP_NORM)),
            ("trainer", "trainer_round_trip", (stack_to_torch(jax_graft[0]), *trainer_case(),
                                               str(tmp_path_factory.mktemp("tp_trainer"))))]
    with ThreadPoolExecutor(1) as pool:
        future = pool.submit(mesh.spawn, workers.run_jobs, DATA * MODEL_PARALLEL, args=(jobs,), device="cpu",
                             model_parallel=MODEL_PARALLEL)
        yield future
        future.exception()  # the ranks end before the module does


@pytest.fixture(scope="module")
def ranks(spawned):
    return spawned.result()


GRAFT_LR = 1e-3  # the dry run's Adam rate
ADAM_EPS = 1e-8


def test_graft_tp_step_matches_jax_on_a_2x2_mesh(ranks, jax_graft):
    """Loss; the averaged gradients within 1e-5 of their scale; the
    parameters after Adam's first step within 1e-5 wherever JAX's gradient
    exceeds 100·eps and within 2·lr everywhere. (The step is
    ``lr·g/(|g| + eps)``: where |g| is near eps a rounding difference in g
    moves an element by up to lr, so the step is not resolved there; the
    same rule as the card's check of this step in ``chip_smoke.py``.)"""
    _, after, loss, sharded, jgrads = jax_graft
    got = ranks["graft"]
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    want, want_g = stack_to_torch(after), stack_to_torch(jgrads)
    assert got["state"].keys() == want.keys() == got["grads"].keys()
    scale = max(float(np.abs(g).max()) for g in want_g.values())
    for k, g in want_g.items():
        np.testing.assert_allclose(got["grads"][k], g, atol=1e-5 * scale, rtol=0, err_msg=k)
    resolved = 0
    for k, w in want.items():
        sure = np.abs(want_g[k]) > 100 * ADAM_EPS
        resolved += int(sure.sum())
        np.testing.assert_allclose(got["state"][k][sure], w[sure], atol=1e-5, rtol=0, err_msg=k)
        np.testing.assert_allclose(got["state"][k], w, atol=2 * GRAFT_LR, rtol=0, err_msg=k)
    assert resolved > 0.9 * sum(w.size for w in want.values())
    # The same kernels sharded: Conv_0 and Conv_1 (128 features), not the head.
    assert sharded == {"params/Conv_0/kernel", "params/Conv_1/kernel"}
    assert got["sharded"] == ["0.weight", "2.weight"]
    assert got["agree"], got["apart"]  # every data rank holds the same slices after the step


@pytest.mark.parametrize("kind", workers.LAYER_KINDS)
def test_column_parallel_layer_equals_the_unsharded_layer(ranks, kind):
    out_err, dx_err, dw_err, sharded = ranks["layers"][kind]
    assert sharded
    assert out_err <= 1e-6 and dx_err <= 1e-6 and dw_err <= 1e-6, (out_err, dx_err, dw_err)


def _update_err(got, want, start):
    num = np.sqrt(sum(((got[n] - want[n]) ** 2).sum() for n in want))
    den = np.sqrt(sum(((want[n] - start[n]) ** 2).sum() for n in want))
    return num / den


@pytest.fixture(scope="module")
def one_process_ranger():
    batch = {k: torch.from_numpy(v) for k, v in unet_batch().items()}
    start = {n: p.detach().numpy().copy() for n, p in workers.narrow_unet().named_parameters()}
    loss, params = workers.ranger_update(workers.narrow_unet(), batch, CLIP_NORM)
    return start, loss, params


def test_clipped_ranger_step_matches_one_process(ranks, one_process_ranger):
    start, loss, params = one_process_ranger
    got = ranks["ranger"]
    assert len(got["sharded"]) > 10  # grouped convs, 1x1s and the SE gates' fc2
    assert abs(got["loss"] - loss) <= 1e-5 * abs(loss)
    assert got["params"].keys() == params.keys()
    assert _update_err(got["params"], params, start) <= 1e-4


def test_rank_local_clip_norm_misses_the_step(ranks, one_process_ranger):
    """The clip must see the whole model's norm: with each rank's own norm
    the update scales differently."""
    start, loss, params = one_process_ranger
    got = ranks["ranger"]
    assert abs(got["local_loss"] - loss) <= 1e-5 * abs(loss)
    assert _update_err(got["local_params"], params, start) > 1e-2


@pytest.fixture(scope="module")
def one_process_trainer(jax_graft, tmp_path_factory):
    model_dir = tmp_path_factory.mktemp("one_trainer")
    return workers.trainer_round_trip(None, stack_to_torch(jax_graft[0]), *trainer_case(), str(model_dir))


def _flat_tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_tensors(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat_tensors(v, f"{prefix}/{i}")
    elif torch.is_tensor(tree):
        yield prefix, tree


def test_trainer_checkpoints_the_whole_model_and_resumes_each_slice(ranks, one_process_trainer):
    """Under 2 x 2 the checkpoint holds what one process's does (the
    sharded layers gathered: module, float32 masters, the ``ranger`` slots),
    and a module with other weights resumes from it into its own slices,
    bit for bit, on every rank; evaluation ran on both model ranks of data
    rank 0 (its gathers would hang on one) and wrote the best checkpoint."""
    got, want = ranks["trainer"], one_process_trainer
    assert got["sharded"] and not want["sharded"]
    assert got["resumed_step"] == want["resumed_step"] == 2
    assert got["same"] and want["same"]
    assert got["best"] and want["best"]
    assert got["state"]["step"] == want["state"]["step"] == 2
    got_t, want_t = dict(_flat_tensors(got["state"])), dict(_flat_tensors(want["state"]))
    assert got_t.keys() == want_t.keys()
    assert any("/optimizer/state/" in k for k in want_t) and want_t.keys() >= {"/masters/0", "/model/0.weight"}
    for k, w in want_t.items():
        g = got_t[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        # bfloat16 forward and gradients (8 bits of mantissa), summed over
        # the ranks in another order: 2e-2 of each tensor's 2-norm.
        num, den = float((g.double() - w.double()).norm()), float(w.double().norm())
        assert num <= 2e-2 * den, (k, num / max(den, 1e-30))


def test_trainer_checkpoint_resumes_in_one_process(ranks, tmp_path):
    """A checkpoint written under a model axis loads into an unsharded
    module: the whole state with one process's shapes."""
    ckpt.save(tmp_path, ranks["trainer"]["state"], global_step=2)
    trainer = workers._stack_trainer(str(tmp_path), trainer_case()[0], None, None)
    state = trainer.init_or_resume()
    assert state.step == 2
    for k, t in ranks["trainer"]["state"]["model"].items():
        assert torch.equal(state.module.state_dict()[k], t), k


# ------------------------------------------------------------------ A9 names


def test_register_backbone_adds_to_both_registries():
    def tiny(**kw):
        return ("tiny", kw)

    try:
        jbackbones.register_backbone("tp_test_tiny", tiny)
        tbackbones.register_backbone("tp_test_tiny", tiny)
        assert tbackbones.build_backbone("tp_test_tiny", a=1) == jbackbones.build_backbone("tp_test_tiny", a=1)
    finally:
        jbackbones.BACKBONES.pop("tp_test_tiny", None)
        tbackbones.BACKBONES.pop("tp_test_tiny", None)


def _active_set(seed, shape=(9, 7, 5), n=60, cap=70):
    rng = np.random.RandomState(seed)
    nx, ny, nz = shape
    flat = rng.choice(nx * ny * nz, n, replace=False)
    coords = np.zeros((cap, 3), np.int32)
    coords[:n] = np.stack([flat % nx, (flat // nx) % ny, flat // (nx * ny)], -1)
    return coords, np.arange(cap) < n, shape


def test_lookup_matches_jax():
    coords, valid, shape = _active_set(0)
    rng = np.random.RandomState(1)
    queries = np.concatenate([coords[rng.permutation(70)[:40]],  # hits, padding rows and all
                              rng.randint(-2, 11, (40, 3)).astype(np.int32)])  # misses, out of range
    ok = rng.rand(80) > 0.1
    jh = jsc.build_hash(jsc.ActiveSet(jnp.asarray(coords), jnp.asarray(valid), shape))
    want = jsc.lookup(*jh, jnp.asarray(queries), jnp.asarray(ok), shape)
    th = tsc.build_hash(tsc.ActiveSet(torch.from_numpy(coords), torch.from_numpy(valid), shape))
    got = tsc.lookup(*th, torch.from_numpy(queries), torch.from_numpy(ok), shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) >= 0).sum() > 10 and (np.asarray(want) < 0).sum() > 10


def test_subm_conv3d_gather_matches_jax():
    coords, valid, shape = _active_set(2)
    feats = np.random.RandomState(3).randn(70, 5).astype(np.float32)
    jactive = jsc.ActiveSet(jnp.asarray(coords), jnp.asarray(valid), shape)
    want = jsc.subm_conv3d_gather(jnp.asarray(feats), jactive, jsc.build_hash(jactive), jsc.kernel_offsets(3))
    tactive = tsc.ActiveSet(torch.from_numpy(coords), torch.from_numpy(valid), shape)
    got = tsc.subm_conv3d_gather(torch.from_numpy(feats), tactive, tsc.build_hash(tactive), tsc.kernel_offsets(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.shape == (27, 70, 5)
