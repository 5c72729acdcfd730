"""Port parity: the backbone families EfficientNet, DPN, WideResNet-38,
Xception, Inception-v4 and Inception-ResNet-v2 against the flax modules.

Each family is built narrow (few blocks, few channels; EfficientNet as b0,
the smallest the flax module offers) and gets its weights from one flax
``init`` with GroupNorm; the BatchNorm and folded trees are derived from it
(flax draws each kernel from a key of its module path, so the three inits
share their kernels): ``GroupNorm_0`` becomes ``BatchNorm_0`` with running
statistics, all drawn with numpy, and the folded tree is the JAX package's
``fold_batch_norms`` of that. Inputs 64² and 65²: at stride 2 flax's
``"SAME"`` pads an even size (0, 1) and an odd one (1, 1), which the
depthwise conv of Xception and the stem max-pools of DPN and WideResNet-38
take. Outputs float32 on both sides within 1e-4 of their scale (the
tolerance of ``test_torch_seresnext.py``). The port's
``fold_batch_norms`` reaches every ConvNormAct of each trunk and gives the
JAX fold's weights (1e-6). At full width, every model the JAX registry has
gets the flax parameter shapes (``jax.eval_shape``, no forward pass).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models import build_model as jax_build_model
from lyft3d_tpu.models import list_models as jax_list_models
from lyft3d_tpu.models.backbones import build_backbone as jax_build_backbone
from lyft3d_tpu.models.fold_bn import fold_batch_norms as jax_fold
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models import layers as tl
from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.utils import flax_params
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layers import nchw, nhwc  # noqa: E402

TOL = 1e-4

FAMILIES = {
    "efficientnet_b0": {},
    "dpn68": dict(stage_sizes=(2, 1, 1, 1), res_features=(16, 32, 32, 64), dense_inc=(4, 8, 8, 8),
                  groups=8),
    "wide_resnet38": dict(stage_sizes=(1, 1, 2, 1),
                          stage_features=((8, 16), (16, 32), (16, 32), (32, 64))),
    "xception": dict(stage_features=(16, 24, 32, 48), middle_reps=1),
    "inception_v4": dict(stage_features=(16, 24, 32, 48), blocks_per_stage=(1, 2, 1, 1)),
    "inceptionresnetv2": dict(stage_features=(16, 24, 32, 48), blocks_per_stage=(1, 2, 1, 1)),
}
# (norm, input size): GroupNorm at both sizes, the other two at one each.
RUNS = (("group", 64), ("group", 65), ("batch", 65), ("folded", 64))


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * float(np.abs(want).max()), rtol=0)


def x_of(hw):
    return np.random.RandomState(hw).rand(1, hw, hw, 6).astype(np.float32)


def batch_from_group(variables, seed):
    """The ``norm_type="batch"`` tree of the same model: every
    ``GroupNorm_0`` becomes a ``BatchNorm_0`` and gets running statistics,
    scales, biases and statistics drawn with numpy."""
    rng = np.random.RandomState(seed)
    stats = {}

    def walk(node, st):
        out = {}
        for k, v in node.items():
            if k == "GroupNorm_0":
                c = v["scale"].shape[0]
                out["BatchNorm_0"] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                                      "bias": rng.normal(0, 0.3, c).astype(np.float32)}
                st["BatchNorm_0"] = {"mean": rng.normal(0, 0.3, c).astype(np.float32),
                                     "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
            elif hasattr(v, "items"):
                sub = {}
                out[k] = walk(v, sub)
                if sub:
                    st[k] = sub
            else:
                out[k] = np.asarray(v)
        return out

    params = walk(variables["params"], stats)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def family_vars():
    """flax variables of each narrow family by norm type (one init each)."""
    made = {}

    def get(family, norm):
        if family not in made:
            jm = jax_build_backbone(family, dtype=jnp.float32, **FAMILIES[family])
            group = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x_of(64))))
            batch = batch_from_group(group, 1)
            made[family] = {"group": group, "batch": batch, "folded": jax_fold(batch)}
        return made[family][norm]

    return get


@pytest.mark.parametrize("norm,hw", RUNS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_backbone_matches_flax(family, norm, hw, family_vars):
    variables = family_vars(family, norm)
    x = x_of(hw)
    jm = jax_build_backbone(family, dtype=jnp.float32, norm_type=norm, **FAMILIES[family])
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_flax_params(build_backbone(family, in_features=6, norm_type=norm, **FAMILIES[family]),
                          variables).eval()
    with torch.no_grad():
        got = tm(nchw(x))
    assert [g.shape[1] for g in got] == list(tm.stage_features)
    s = -(-hw // 4)
    assert [tuple(g.shape[-2:]) for g in got] == [(s, s), (-(-s // 2),) * 2, (-(-s // 4),) * 2,
                                                  (-(-s // 8),) * 2]
    for g, w in zip(got, want):
        close(nhwc(g), w)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fold_reaches_every_conv_norm_pair(family, family_vars):
    """The port's fold of the BatchNorm trunk leaves no norm op and gives the
    weights of the JAX fold, which finds every ``Conv_0``/``BatchNorm_0``
    pair (none is left in its tree)."""
    batch, folded = family_vars(family, "batch"), family_vars(family, "folded")
    assert not any("BatchNorm" in "/".join(p) for p, _ in _flat(folded["params"]))
    tm = load_flax_params(build_backbone(family, in_features=6, norm_type="batch",
                                         **FAMILIES[family]), batch)
    got = fold_batch_norms(tm)
    assert not any(isinstance(m, tl.BatchNorm) for m in got.modules())
    want = load_flax_params(build_backbone(family, in_features=6, norm_type="folded",
                                           **FAMILIES[family]), folded)
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        close(got.state_dict()[k], v, 1e-6)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_export_round_trip_and_same_pads():
    """Every family's tree goes back out through ``export_flax_params``
    unchanged; flax's ``"SAME"`` pads of a 3-wide window: (0, 1) on an even
    size at stride 2, (1, 1) on an odd one and at stride 1."""
    for family, kw in FAMILIES.items():
        jm = jax_build_backbone(family, dtype=jnp.float32, norm_type="batch", **kw)
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 64, 64, 6),
                                                                                    jnp.float32))
        rng = np.random.RandomState(0)
        tree = jax.tree_util.tree_map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
        back = export_flax_params(load_flax_params(
            build_backbone(family, in_features=6, norm_type="batch", **kw), tree))
        want = dict(_flat(tree))
        got = dict(_flat(back))
        assert got.keys() == want.keys(), family
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg="/".join(path))
    assert tl.same_pads(64, 3, 2) == (0, 1) and tl.same_pads(65, 3, 2) == (1, 1)
    assert tl.same_pads(64, 3, 1) == (1, 1) == tl.same_pads(65, 3, 1)


@pytest.mark.parametrize("hw", [6, 7])
def test_avg_and_max_pool_same_match_flax(hw):
    """flax's ``avg_pool`` counts the padded zeros (``count_include_pad``),
    its ``max_pool`` never takes the pad; odd and even sizes."""
    from flax import linen as fnn

    x = np.random.RandomState(hw).randn(2, hw, hw, 3).astype(np.float32) - 2.0
    want = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(1, 1), padding="SAME"))
    close(nhwc(tl.avg_pool_same(nchw(x), 3, 1)), want, 1e-6)
    torch_pad = torch.nn.functional.avg_pool2d(nchw(x), 3, 1, padding=1, count_include_pad=True)
    close(nhwc(torch_pad), want, 1e-6)
    want = np.asarray(fnn.max_pool(jnp.asarray(x), (3, 3), strides=(2, 2), padding="SAME"))
    np.testing.assert_array_equal(nhwc(tl.max_pool_same(nchw(x), 3, 2)), want)


def _shapes_of(model):
    """flax path → shape of every tensor the bridge maps, from a model on the
    ``meta`` device (no values needed)."""
    refs = {}
    flax_params._MAPPERS[type(model)](model, flax_params._Recorder(), (), "", refs)
    targets = dict(model.named_parameters())
    targets.update(model.named_buffers())
    out = {}
    for key, ref in refs.items():
        shape = tuple(targets[key].shape)
        if ref.perm is not None:
            shape = tuple(shape[i] for i in np.argsort(ref.perm))
        out[(ref.collection,) + ref.path] = shape
    return out


NEW_MODELS = sorted(set(jax_list_models()) - {
    "unet_reference", "unet_resnet18", "unet_resnet34", "unet_resnet50", "unet_seresnext26",
    "unet_seresnext50", "unet_seresnext101"})


@pytest.mark.parametrize("name", NEW_MODELS)
def test_full_width_model_has_flax_parameter_shapes(name):
    """Every model of the JAX registry the port gained, at full width: the
    port's tensors under the bridge's names have the shapes of flax's
    ``jax.eval_shape(model.init)`` (BatchNorm where the model takes a norm
    choice, so running statistics are compared too)."""
    kw = {} if name.startswith("efficientnet") else {"norm_type": "batch"}
    jm = jax_build_model(name, n_classes=10, dtype=jnp.float32, **kw)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 64, 64, 6), jnp.float32))
    want_shapes = {p: tuple(v.shape) for p, v in _flat(want)}
    got_shapes = _shapes_of(build_model(name, n_classes=10, device="meta", **kw))
    assert got_shapes == want_shapes
