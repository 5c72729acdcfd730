"""Port parity: ``lyft3d_tpu_torch.models.layers`` and ``fold_bn`` against the
flax modules, on the same numpy inputs and the same weights (flax init,
norm parameters and running statistics randomised with numpy, copied over by
``load_flax_params``).

Tolerances: both sides compute in float32 but sum convolutions in different
orders (XLA vs oneDNN), so outputs of O(1) agree to about 1e-6; the checks
allow 1e-4 absolute + 1e-4 relative. Resizes involve no long sums and are
held to 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models import layers as jl
from lyft3d_tpu.models.fold_bn import fold_batch_norms as jax_fold
from lyft3d_tpu_torch.models import layers as tl
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

ATOL = RTOL = 1e-4


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def randomized(variables, seed):
    """flax variables with norm scales/biases and running stats replaced by
    numpy draws (init leaves them at 1/0, which would hide a mix-up)."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            if k == "var":
                v = rng.uniform(0.5, 2.0, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k in ("bias", "mean"):
                v = rng.normal(0.0, 0.3, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return walk(variables, ())


def flax_vars(module, *inputs, seed=0):
    v = jax.jit(module.init)(jax.random.PRNGKey(seed), *[jnp.asarray(x) for x in inputs])
    return randomized(jax.device_get(v), seed)


def apply(module, variables, *inputs):
    return np.asarray(jax.jit(module.apply)(variables, *[jnp.asarray(x) for x in inputs]))


def close(got, want):
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("hw_in,hw_out", [(22, 21), (11, 22), (22, 168)])
def test_resize_to(hw_in, hw_out):
    x = np.random.RandomState(hw_in).randn(2, hw_in, hw_in, 5).astype(np.float32)
    want = np.asarray(jl.resize_to(jnp.asarray(x), (hw_out, hw_out)))
    got = nhwc(tl.resize_to(nchw(x), (hw_out, hw_out)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_upsample2x():
    x = np.random.RandomState(1).randn(1, 11, 7, 3).astype(np.float32)
    np.testing.assert_allclose(
        nhwc(tl.upsample2x(nchw(x))), np.asarray(jl.upsample2x(jnp.asarray(x))), atol=1e-5
    )


@pytest.mark.parametrize("norm_type", ["group", "batch", "folded"])
@pytest.mark.parametrize("kw", [dict(strides=2), dict(dilation=6), dict(kernel=1, groups=4)],
                         ids=["stride2", "dilation6", "1x1_groups4"])
def test_conv_norm_act(norm_type, kw):
    x = np.random.RandomState(0).randn(2, 13, 13, 16).astype(np.float32)
    jm = jl.ConvNormAct(32, norm_type=norm_type, dtype=jnp.float32, **kw)
    v = flax_vars(jm, x)
    tm = tl.ConvNormAct(16, 32, norm_type=norm_type, **kw).eval()
    load_flax_params(tm, v)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), apply(jm, v, x))


def test_num_groups():
    for f in (1, 3, 6, 12, 24, 64, 100, 320):
        assert tl._num_groups(f) == jl._num_groups(f)


def test_se_module():
    x = np.random.RandomState(2).randn(2, 6, 6, 64).astype(np.float32)
    jm = jl.SEModule(dtype=jnp.float32)
    v = flax_vars(jm, x)
    tm = load_flax_params(tl.SEModule(64), v)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), apply(jm, v, x))


@pytest.mark.parametrize("norm_type", ["group", "batch"])
def test_aspp(norm_type):
    # 11x11 as the /32 stage of a 336 input; rates reach past the border.
    x = np.random.RandomState(3).randn(1, 11, 11, 48).astype(np.float32)
    jm = jl.ASPP(64, norm_type=norm_type, dtype=jnp.float32)
    v = flax_vars(jm, x)
    tm = load_flax_params(tl.ASPP(48, 64, norm_type=norm_type).eval(), v)
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), apply(jm, v, x))


@pytest.mark.parametrize("skip_hw", [None, 21, 22], ids=["no_skip", "shrink", "same"])
def test_up_block(skip_hw):
    rng = np.random.RandomState(4)
    x = rng.randn(1, 11, 11, 24).astype(np.float32)
    skip = None if skip_hw is None else rng.randn(1, skip_hw, skip_hw, 8).astype(np.float32)
    inputs = (x,) if skip is None else (x, skip)
    jm = jl.UpBlock(16, dtype=jnp.float32)
    v = flax_vars(jm, *inputs)
    tm = load_flax_params(tl.UpBlock(24, 0 if skip is None else 8, 16), v)
    with torch.no_grad():
        got = tm(*[nchw(a) for a in inputs])
    close(nhwc(got), apply(jm, v, *inputs))


def test_fold_batch_norms_matches_jax_fold():
    rng = np.random.RandomState(5)
    x = rng.randn(1, 11, 11, 24).astype(np.float32)
    skip = rng.randn(1, 21, 21, 8).astype(np.float32)
    batch_vars = flax_vars(jl.UpBlock(16, norm_type="batch", dtype=jnp.float32), x, skip)
    folded_vars = jax.device_get(jax_fold(batch_vars))
    want = apply(jl.UpBlock(16, norm_type="folded", dtype=jnp.float32), folded_vars, x, skip)

    batch_model = load_flax_params(tl.UpBlock(24, 8, 16, norm_type="batch").eval(), batch_vars)
    folded = fold_batch_norms(batch_model)
    direct = load_flax_params(tl.UpBlock(24, 8, 16, norm_type="folded"), folded_vars)
    # Same structure as a model built folded, same numbers as the JAX fold.
    assert folded.state_dict().keys() == direct.state_dict().keys()
    for k, t in folded.state_dict().items():
        np.testing.assert_allclose(t.numpy(), direct.state_dict()[k].numpy(), rtol=1e-6, atol=1e-6)
    # The original keeps its BatchNorms.
    assert isinstance(batch_model.conv1.norm, torch.nn.BatchNorm2d)
    with torch.no_grad():
        close(nhwc(folded(nchw(x), nchw(skip))), want)
        close(nhwc(batch_model(nchw(x), nchw(skip))), want)
