"""BatchNorm of the port (``ConvNormAct(norm_type="batch")``) against flax's
``nn.BatchNorm`` in train mode: momentum 0.99, the biased one-pass float32
batch variance, float32 running statistics in a bfloat16 module.

From equal weights (flax init → ``load_flax_params``), one train-mode step
of a ``ConvNormAct`` and of ``unet_seresnext26`` on ``tests/test_batchnorm.py``'s
setup (1 × 64 × 64 × 6, ``norm_type="batch"``): outputs, the input gradient
of a fixed linear functional of them, and every running mean and variance;
then eval mode and the fold on the updated statistics. Float32 on both
sides, summed in other orders (XLA, oneDNN) through the deep trunk: outputs
within 1e-4 of their scale, running statistics within 1e-5 of theirs. The
input gradient of the UNet is ill-conditioned at this size (train-mode
statistics over 4 values a channel at /32, ReLU inputs within rounding of
0): it is held to 1e-2 in the 2-norm (a gradient that skipped the
statistics would be off by O(1)); the ``ConvNormAct``'s to 1e-4 of scale. The fold keeps
``tests/test_batchnorm.py``'s 2e-4.
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
from lyft3d_tpu.models.fold_bn import fold_batch_norms as jax_fold
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models import layers as tl
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layers import nchw, nhwc, randomized  # noqa: E402


def close(got, want, tol):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


class Case:
    """A flax module and its port, with the port's input and output layouts."""

    def __init__(self, name):
        self.name = name
        if name == "conv_norm_act":
            self.x = np.random.RandomState(0).randn(2, 13, 13, 16).astype(np.float32)
            self.jm = jl.ConvNormAct(32, strides=2, norm_type="batch", dtype=jnp.float32)
        else:
            self.x = np.random.RandomState(0).randn(1, 64, 64, 6).astype(np.float32)
            self.jm = jax_build_model("unet_seresnext26", n_classes=4, norm_type="batch",
                                      dtype=jnp.float32)
        v = jax.device_get(jax.jit(self.jm.init)(jax.random.PRNGKey(0), jnp.asarray(self.x)))
        # Running statistics drawn with numpy (an update from 0 and 1 would
        # hide a swapped momentum less well); scales and biases as flax inits
        # them.
        stats = randomized({"batch_stats": v["batch_stats"]}, 1)
        self.variables = {"params": v["params"], **stats}

    def port(self, dtype=torch.float32):
        if self.name == "conv_norm_act":
            m = tl.ConvNormAct(16, 32, strides=2, norm_type="batch", dtype=dtype)
        else:
            m = build_model("unet_seresnext26", n_classes=4, norm_type="batch", dtype=dtype)
        return load_flax_params(m, self.variables)

    def run(self, model, x):
        """Outputs as NHWC float32 tensors; ``x`` NHWC."""
        if self.name == "conv_norm_act":
            return (model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1),)
        return model(x)

    def cotangents(self, outs):
        rng = np.random.RandomState(2)
        return [rng.randn(*o.shape).astype(np.float32) for o in outs]

    def jax_train_step(self):
        """Outputs, input gradient and updated batch_stats of one train-mode
        apply (``mutable=["batch_stats"]``)."""
        outs0, _ = self.jm.apply(self.variables, jnp.asarray(self.x), mutable=["batch_stats"])
        outs0 = outs0 if isinstance(outs0, tuple) else (outs0,)
        cots = self.cotangents(outs0)

        def f(x):
            outs, state = self.jm.apply(self.variables, x, mutable=["batch_stats"])
            outs = outs if isinstance(outs, tuple) else (outs,)
            return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), (outs, state)

        (_, (outs, state)), grad = jax.jit(jax.value_and_grad(f, has_aux=True))(jnp.asarray(self.x))
        return [np.asarray(o) for o in outs], np.asarray(grad), jax.device_get(state["batch_stats"]), cots

    def port_train_step(self, model, cots):
        model.train()
        x = torch.from_numpy(self.x).requires_grad_(True)
        outs = self.run(model, x)
        sum((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots)).backward()
        return [o.detach().numpy() for o in outs], x.grad.numpy()


@pytest.fixture(scope="module")
def cases():
    built = {}

    def get(name):
        if name not in built:
            case = Case(name)
            case.jax = case.jax_train_step()
            built[name] = case
        return built[name]

    return get


CASES = ["conv_norm_act", "unet_seresnext26"]


@pytest.mark.parametrize("name", CASES)
def test_train_step_matches_flax(cases, name):
    case = cases(name)
    want_outs, want_grad, want_stats, cots = case.jax
    model = case.port()
    got_outs, got_grad = case.port_train_step(model, cots)
    for g, w in zip(got_outs, want_outs):
        close(g, w, 1e-4)
    if name == "conv_norm_act":
        close(got_grad, want_grad, 1e-4)
    else:
        assert np.linalg.norm(got_grad - want_grad) <= 1e-2 * np.linalg.norm(want_grad)
    got_stats = flat(export_flax_params(model)["batch_stats"])
    want_stats = flat(want_stats)
    assert got_stats.keys() == want_stats.keys() and len(got_stats) >= 2
    before = flat(case.variables["batch_stats"])
    for path, w in want_stats.items():
        close(got_stats[path], w, 1e-5)
        assert np.abs(w - before[path]).max() > 1e-4, path  # every statistic moved


@pytest.mark.parametrize("name", CASES)
def test_eval_mode_after_a_train_step_matches_flax(cases, name):
    """Eval mode normalises with the running statistics the train step left."""
    case = cases(name)
    _, _, want_stats, cots = case.jax
    model = case.port()
    case.port_train_step(model, cots)
    updated = dict(case.variables, batch_stats=want_stats)
    want = case.jm.apply(updated, jnp.asarray(case.x))
    want = want if isinstance(want, tuple) else (want,)
    model.eval()
    with torch.no_grad():
        got = case.run(model, torch.from_numpy(case.x))
    for g, w in zip(got, want):
        close(g.numpy(), np.asarray(w), 1e-4)


def test_fold_of_trained_statistics_is_exact(cases):
    """``fold_batch_norms`` after a train step equals the batch model in eval
    mode, and its conv weights and biases are the JAX fold of the JAX step's
    statistics (1e-5 of each leaf's scale)."""
    case = cases("unet_seresnext26")
    _, _, want_stats, cots = case.jax
    model = case.port()
    case.port_train_step(model, cots)
    folded = fold_batch_norms(model.eval())
    x = torch.from_numpy(case.x)
    with torch.no_grad():
        got = folded(x)[0].numpy()
        unfolded = model(x)[0].numpy()
    np.testing.assert_allclose(got, unfolded, rtol=2e-4, atol=2e-4)
    want = flat(jax.device_get(jax_fold(dict(case.variables, batch_stats=want_stats)))["params"])
    have = flat(export_flax_params(folded)["params"])
    assert have.keys() == want.keys() and any(k[-1] == "bias" and "Conv_0" in k for k in want)
    for path, w in want.items():
        close(have[path], w, 1e-5)


def test_running_statistics_stay_float32_in_a_bfloat16_module(cases):
    """Built in bfloat16, the module keeps float32 running statistics: after
    one train-mode step each is ``0.99·before + 0.01·batch`` in float32 (in
    bfloat16 most of these updates would round away), the bridge reads and
    writes them in float32, and the output keeps the input's dtype."""
    case = cases("unet_seresnext26")
    model = case.port(torch.bfloat16)
    norms = [m for m in model.modules() if isinstance(m, tl.BatchNorm)]
    assert norms and all(m.weight.dtype == torch.bfloat16 for m in norms)
    assert all(b.dtype == torch.float32 for m in norms for b in (m.running_mean, m.running_var))
    before = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    model.train()
    logits, _ = model(torch.from_numpy(case.x))
    assert logits.dtype == torch.float32  # the float32 head
    lost = 0
    for m, (mean0, var0) in zip(norms, before):
        mean, var = m.batch_stats
        assert mean.dtype == var.dtype == m.running_mean.dtype == torch.float32
        assert torch.equal(m.running_mean, 0.99 * mean0 + (1.0 - 0.99) * mean)
        assert torch.equal(m.running_var, 0.99 * var0 + (1.0 - 0.99) * var)
        for new, old in ((m.running_mean, mean0), (m.running_var, var0)):
            lost += int(((new.bfloat16() == old.bfloat16()) & (new != old)).sum())
    assert lost > 1000  # updates that bfloat16 buffers would have rounded away
    stats = flat(export_flax_params(model)["batch_stats"])
    assert all(v.dtype == np.float32 for v in stats.values())
    reloaded = load_flax_params(case.port(torch.bfloat16), export_flax_params(model))
    for a, b in zip(norms, [m for m in reloaded.modules() if isinstance(m, tl.BatchNorm)]):
        assert torch.equal(a.running_mean, b.running_mean) and torch.equal(a.running_var, b.running_var)
    conv = tl.ConvNormAct(16, 32, norm_type="batch", dtype=torch.bfloat16)
    y = conv.train()(torch.randn(2, 16, 5, 5, dtype=torch.bfloat16))
    assert y.dtype == torch.bfloat16 and conv.norm.running_var.dtype == torch.float32


@pytest.mark.parametrize("cast", ["to_bfloat16", "bfloat16", "half", "double", "to_cpu"])
def test_running_statistics_stay_float32_through_module_casts(cast):
    """Any cast of a built module (not only ``materialize``'s) casts the
    weights and leaves BatchNorm's running statistics float32, with their
    values; a train-mode step of the cast module then updates them in
    float32."""
    conv = tl.ConvNormAct(16, 32, norm_type="batch")
    with torch.no_grad():
        conv.norm.running_mean.uniform_(-1.0, 1.0)
        conv.norm.running_var.uniform_(0.5, 2.0)
    before = (conv.norm.running_mean.clone(), conv.norm.running_var.clone())
    dtype = {"to_bfloat16": torch.bfloat16, "bfloat16": torch.bfloat16, "half": torch.float16,
             "double": torch.float64, "to_cpu": torch.float32}[cast]
    conv = {"to_bfloat16": lambda m: m.to(torch.bfloat16), "bfloat16": lambda m: m.bfloat16(),
            "half": lambda m: m.half(), "double": lambda m: m.double(),
            "to_cpu": lambda m: m.to("cpu")}[cast](conv)
    assert conv.conv.weight.dtype == conv.norm.weight.dtype == dtype
    for buf, old in zip((conv.norm.running_mean, conv.norm.running_var), before):
        assert buf.dtype == torch.float32 and torch.equal(buf, old)
    conv.train()(torch.randn(2, 16, 5, 5).to(dtype))
    mean, var = conv.norm.batch_stats
    assert torch.equal(conv.norm.running_var, 0.99 * before[1] + (1.0 - 0.99) * var.float())
    assert conv.norm.running_mean.dtype == conv.norm.running_var.dtype == torch.float32
