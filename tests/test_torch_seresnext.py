"""Port parity: the SE-ResNeXt backbones and ``unet_seresnext*`` against the
flax models.

Weights from flax ``init`` through ``load_flax_params`` (BatchNorm running
statistics drawn with numpy), the same numpy input (1 × 48 × 48 × 6, where
the /16 stage is odd as at 336), float32 on both sides. The JAX side runs its
grouped convolutions as block-diagonal ``PackedGroupedConv``s, the port as
``nn.Conv2d(groups=32)``: the same function, summed in other orders, so
outputs are held to 1e-4 of their scale (the relative tolerance of
``tests/test_torch_unet.py``, over a deeper trunk of grouped sums). The
grouped kernel itself, packed and plain, maps by the plain HWIO → OIHW
transpose (1e-5). At full width, the parameter tree of ``unet_seresnext101``
has the shapes of flax's ``jax.eval_shape(model.init)``, without a forward
pass.
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models import build_model as jax_build_model
from lyft3d_tpu.models import layers as jl
from lyft3d_tpu.models.backbones import build_backbone as jax_build_backbone
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models import layers as tl
from lyft3d_tpu_torch.models.backbones import build_backbone
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layers import nchw, nhwc, randomized  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(0).rand(1, 48, 48, 6).astype(np.float32)


@pytest.fixture(scope="module")
def unet_vars(x):
    """flax variables of ``unet_seresnext26`` by norm type (one init each)."""
    made = {}

    def get(norm):
        if norm not in made:
            jm = jax_build_model("unet_seresnext26", n_classes=10, norm_type=norm, dtype=jnp.float32)
            v = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
            if norm == "batch":
                v = {"params": v["params"], **randomized({"batch_stats": v["batch_stats"]}, 1)}
            made[norm] = v
        return made[norm]

    return get


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("what", ["backbone", "unet"])
def test_forward_matches_flax(what, norm, x, unet_vars):
    variables = unet_vars(norm)
    if what == "unet":
        jm = jax_build_model("unet_seresnext26", n_classes=10, norm_type=norm, dtype=jnp.float32)
        tm = build_model("unet_seresnext26", n_classes=10, norm_type=norm).eval()
        want = jax.jit(jm.apply)(variables, jnp.asarray(x))
        with torch.no_grad():
            got = load_flax_params(tm, variables)(torch.from_numpy(x))
        for g, w in zip(got, want):
            close(g.numpy(), w)
        return
    # The backbone alone, on the UNet's backbone subtree.
    sub = {k: v["SEResNeXt_0"] for k, v in variables.items()}
    jm = jax_build_backbone("seresnext26", norm_type=norm, dtype=jnp.float32)
    tm = build_backbone("seresnext26", in_features=6, norm_type=norm).eval()
    want = jax.jit(jm.apply)(sub, jnp.asarray(x))
    with torch.no_grad():
        got = load_flax_params(tm, sub)(nchw(x))
    assert [g.shape[1] for g in got] == list(tm.stage_features) == [256, 512, 1024, 2048]
    for g, w in zip(got, want):
        close(nhwc(g), w)


@pytest.mark.parametrize("pack", ["always", "never"])
def test_grouped_kernel_is_the_plain_transpose(pack):
    """flax's grouped kernel ``(kh, kw, in/g, out)`` gives output channel
    ``o`` to group ``o // (out/g)`` packed or not, as torch's ``(out, in/g,
    kh, kw)`` does: HWIO → OIHW, nothing else. 128 → 128 channels in 32
    groups of 4, stride 2, as the first stage's grouped convolution."""
    xs = np.random.RandomState(3).randn(2, 11, 11, 128).astype(np.float32)
    jm = jl.ConvNormAct(128, strides=2, groups=32, pack_groups=pack, dtype=jnp.float32)
    v = randomized(jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(xs))), 2)
    tm = load_flax_params(tl.ConvNormAct(128, 128, strides=2, groups=32), v)
    kernel = v["params"]["Conv_0"]["kernel"]
    assert kernel.shape == (3, 3, 4, 128)
    assert torch.equal(tm.conv.weight, torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
    with torch.no_grad():
        close(nhwc(tm(nchw(xs))), jax.jit(jm.apply)(v, jnp.asarray(xs)), 1e-5)


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_export_round_trip(norm, unet_vars):
    variables = unet_vars(norm)
    tm = load_flax_params(build_model("unet_seresnext26", n_classes=10, norm_type=norm), variables)
    back = export_flax_params(tm)
    want = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


def test_full_width_seresnext101_has_flax_parameter_shapes():
    """The yaml's model at full width (no forward pass on the CPU)."""
    jm = jax_build_model("unet_seresnext101", n_classes=10, norm_type="batch", dtype=jnp.float32)
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jax.ShapeDtypeStruct((1, 64, 64, 6), jnp.float32))
    tm = build_model("unet_seresnext101", n_classes=10, norm_type="batch")
    got = export_flax_params(tm)
    want_shapes = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in jax.tree_util.tree_leaves_with_path(want)}
    got_shapes = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in jax.tree_util.tree_leaves_with_path(got)}
    assert got_shapes == want_shapes
    n_params = sum(int(np.prod(s)) for k, s in got_shapes.items() if k.startswith("['params']"))
    assert n_params == sum(p.numel() for p in tm.parameters()) > 40_000_000
    assert sum(1 for k in got_shapes if "SEResNeXtBlock_" in k and k.endswith("['kernel']")) > 0
