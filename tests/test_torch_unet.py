"""Port parity: whole UNets of ``lyft3d_tpu_torch`` against the flax models.

Each model is built in both packages in float32, gets its weights from flax
``init`` through ``load_flax_params`` (the folded ResNet-50's init is derived
from the GroupNorm one's, see ``folded_from_group``), and runs on the same
numpy input: 48x48x6 at batch 1, at full channel width. Like 336, 48 makes the /16 stage
odd (3 against 2 at /32), so the first decoder resize shrinks (antialiased)
as it does at the Lyft size.

Tolerance: float32 on both sides, but XLA and oneDNN sum the convolutions in
different orders and the deep ResNet-50 trunk (with GroupNorm renormalising
at every layer) amplifies the last-bit differences. Logits and aux must
agree to 1e-4 absolute + 1e-4 relative.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.models import build_model as jax_build_model
from lyft3d_tpu.models import list_models as jax_list_models
from lyft3d_tpu_torch.models import build_model, list_models
from lyft3d_tpu_torch.utils.flax_params import load_flax_params

ATOL = RTOL = 1e-4

CASES = {
    "resnet50_group": ("unet_resnet50", {"norm_type": "group"}),
    "resnet50_folded": ("unet_resnet50", {"norm_type": "folded"}),
    "resnet18_group": ("unet_resnet18", {}),
    "reference_wf3_depth2": ("unet_reference", {"wf": 3, "depth": 2}),
}


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(0).rand(1, 48, 48, 6).astype(np.float32)


def flax_vars(name, kw, x, seed=0):
    model = jax_build_model(name, n_classes=10, dtype=jnp.float32, **kw)
    return jax.device_get(jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x)))


def folded_from_group(variables, seed=0):
    """The folded model's init from the GroupNorm model's, without a second
    flax init compile: flax draws each kernel from a key derived from its
    module path, so the two inits give the same kernels; the folded model
    adds a conv bias where the GroupNorm was. Init makes that bias 0; here it
    is drawn with numpy so that a misplaced bias cannot go unseen."""
    rng = np.random.RandomState(seed)

    def walk(node):
        node = {k: walk(v) if isinstance(v, dict) else v for k, v in node.items()}
        if "GroupNorm_0" in node:
            del node["GroupNorm_0"]
            cout = node["Conv_0"]["kernel"].shape[-1]
            node["Conv_0"] = {**node["Conv_0"],
                              "bias": rng.normal(0, 0.1, cout).astype(np.float32)}
        return node

    return {"params": walk(variables["params"])}


@pytest.fixture(scope="module")
def resnet50_group_vars(x):
    return flax_vars("unet_resnet50", {"norm_type": "group"}, x)


@pytest.mark.parametrize("case", list(CASES))
def test_unet_matches_flax(case, x, request):
    name, kw = CASES[case]
    if case == "resnet50_group":
        variables = request.getfixturevalue("resnet50_group_vars")
    elif case == "resnet50_folded":
        variables = folded_from_group(request.getfixturevalue("resnet50_group_vars"))
    else:
        variables = flax_vars(name, kw, x)
    jm = jax_build_model(name, n_classes=10, dtype=jnp.float32, **kw)
    want_logits, want_aux = (np.asarray(a) for a in jax.jit(jm.apply)(variables, jnp.asarray(x)))

    tm = load_flax_params(build_model(name, n_classes=10, **kw), variables).eval()
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(x))
    assert logits.shape == (1, 48, 48, 10) and aux.shape == (1, 10)
    assert logits.dtype == aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(aux.numpy(), want_aux, atol=ATOL, rtol=RTOL)


def test_bridge_raises_on_missing_and_extra_leaves(x):
    variables = flax_vars("unet_reference", {"wf": 2, "depth": 1}, x)
    model = build_model("unet_reference", n_classes=10, wf=2, depth=1)
    load_flax_params(model, variables)  # the full tree loads

    params = variables["params"]
    missing = {"params": {k: v for k, v in params.items() if k != "Conv_0"}}
    with pytest.raises(KeyError, match="Conv_0"):
        load_flax_params(model, missing)

    extra = {"params": {**params, "Dense_9": {"kernel": np.zeros((2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="Dense_9"):
        load_flax_params(model, extra)

    wrong_shape = {"params": {**params, "Conv_0": {
        "kernel": np.zeros((1, 1, 4, 3), np.float32), "bias": np.zeros(3, np.float32)}}}
    with pytest.raises(ValueError, match="head"):
        load_flax_params(model, wrong_shape)


def test_registry_names():
    """The port's registry has every name of the JAX package's, and no other."""
    assert list_models() == jax_list_models()
    assert {"unet_reference", "unet_resnet18", "unet_resnet34", "unet_resnet50", "unet_seresnext101",
            "unet_seresnext26", "unet_seresnext50", "unet_dpn68", "deeplab_seresnext50",
            "efficientnet_b5_unet"} <= set(list_models())


def test_same_generator_seed_gives_same_weights():
    def make():
        return build_model("unet_reference", wf=2, depth=1,
                           generator=torch.Generator().manual_seed(3))

    a, b = make().state_dict(), make().state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
