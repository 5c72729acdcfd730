"""Port parity: the DeepLabV3+ and EfficientNet-UNet heads against the flax
models, and a DeepLabV3+ training step.

Narrow models (``DeepLabV3Plus(backbone="resnet18", aspp_features=32,
low_features=8)`` at output stride 8; ``EfficientNetUNet`` over b0 with a
(32, 16, 16, 8) decoder) get their weights from flax ``init`` through
``load_flax_params``; the BatchNorm tree is derived from the GroupNorm one
(``test_torch_backbones.batch_from_group``) and the folded tree is the JAX
fold of it. Inputs 64² and 65² (at 65 the /4 skip is 17 and the /8 map 9, so
the ASPP output is upsampled to an odd size and the logits from 17 to 65).
Logits and aux float32 within 1e-4 of their scale. Training: two ``ranger``
steps (clip 5, weight decay 0.01) through ``make_bev_loss_fn`` /
``make_bev_optimizer_fn`` on the ``Trainer``, from equal weights at 64² with
GroupNorm: losses within 1e-5 relative, every parameter within 2e-2 of how far
it moved (``test_torch_bev_train.py``'s tolerances).
"""

import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.config import BEVExperiment as JBEVExperiment
from lyft3d_tpu.config import OptimizerConfig as JOptimizerConfig
from lyft3d_tpu.models.deeplab import DeepLabV3Plus as JDeepLab
from lyft3d_tpu.models.deeplab import EfficientNetUNet as JEffUNet
from lyft3d_tpu.models.fold_bn import fold_batch_norms as jax_fold
from lyft3d_tpu.train import trainer as jtrainer
from lyft3d_tpu_torch.config import BEVExperiment, OptimizerConfig
from lyft3d_tpu_torch.models import build_model
from lyft3d_tpu_torch.models.deeplab import DeepLabV3Plus, EfficientNetUNet
from lyft3d_tpu_torch.models.fold_bn import fold_batch_norms
from lyft3d_tpu_torch.pipelines import bev_train as tbev_train
from lyft3d_tpu_torch.train.trainer import Trainer, TrainerConfig, TrainState
from lyft3d_tpu_torch.utils.flax_params import export_flax_params, load_flax_params

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_backbones import batch_from_group  # noqa: E402
from test_torch_bev_train import bev_batch, flat, jax_training_pieces  # noqa: E402

TOL = 1e-4
DEEPLAB = dict(backbone="resnet18", aspp_features=32, low_features=8)
EFFUNET = dict(backbone="efficientnet_b0", decoder_features=(32, 16, 16, 8))
RUNS = (("group", 64), ("group", 65), ("batch", 65), ("folded", 64))


def close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * float(np.abs(want).max()), rtol=0)


def x_of(hw, batch=1):
    return np.random.RandomState(hw).rand(batch, hw, hw, 6).astype(np.float32)


@pytest.fixture(scope="module")
def deeplab_vars():
    made = {}

    def get(norm):
        if not made:
            jm = JDeepLab(n_classes=10, dtype=jnp.float32, **DEEPLAB)
            group = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x_of(64))))
            batch = batch_from_group(group, 2)
            made.update(group=group, batch=batch, folded=jax_fold(batch))
        return made[norm]

    return get


@pytest.mark.parametrize("norm,hw", RUNS)
def test_deeplab_matches_flax(norm, hw, deeplab_vars):
    variables = deeplab_vars(norm)
    x = x_of(hw)
    jm = JDeepLab(n_classes=10, dtype=jnp.float32, norm_type=norm, **DEEPLAB)
    want_logits, want_aux = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = load_flax_params(DeepLabV3Plus(n_classes=10, norm_type=norm, **DEEPLAB), variables).eval()
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(x))
    assert logits.shape == (1, hw, hw, 10) and aux.shape == (1, 10)
    assert logits.dtype == aux.dtype == torch.float32
    close(logits.numpy(), want_logits)
    close(aux.numpy(), want_aux)


def test_deeplab_fold_of_batch_gives_the_folded_model(deeplab_vars):
    tm = load_flax_params(DeepLabV3Plus(n_classes=10, norm_type="batch", **DEEPLAB),
                          deeplab_vars("batch")).eval()
    want = load_flax_params(DeepLabV3Plus(n_classes=10, norm_type="folded", **DEEPLAB),
                            deeplab_vars("folded")).eval()
    got = fold_batch_norms(tm)
    assert got.state_dict().keys() == want.state_dict().keys()
    for k, v in want.state_dict().items():
        close(got.state_dict()[k], v, 1e-6)


@pytest.fixture(scope="module")
def effunet_vars():
    jm = JEffUNet(n_classes=10, dtype=jnp.float32, **EFFUNET)
    return jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.asarray(x_of(64))))


@pytest.mark.parametrize("hw", [64, 65])
def test_efficientnet_unet_matches_flax(hw, effunet_vars):
    x = x_of(hw, batch=2)
    jm = JEffUNet(n_classes=10, dtype=jnp.float32, **EFFUNET)
    want_logits, want_aux = jax.jit(jm.apply)(effunet_vars, jnp.asarray(x))
    tm = load_flax_params(EfficientNetUNet(n_classes=10, **EFFUNET), effunet_vars).eval()
    with torch.no_grad():
        logits, aux = tm(torch.from_numpy(x))
    assert logits.shape == (2, hw, hw, 10) and aux.shape == (2, 10)
    close(logits.numpy(), want_logits)
    close(aux.numpy(), want_aux)


def test_efficientnet_unet_has_group_norm_only_and_heads_round_trip(effunet_vars, deeplab_vars):
    """The flax EfficientNet-UNet takes no norm choice; both heads' trees go
    back out through ``export_flax_params`` unchanged."""
    for norm in ("batch", "folded"):
        with pytest.raises(ValueError, match="GroupNorm only"):
            build_model("efficientnet_b3_unet", norm_type=norm)
    for model, tree in ((EfficientNetUNet(n_classes=10, **EFFUNET), effunet_vars),
                        (DeepLabV3Plus(n_classes=10, norm_type="batch", **DEEPLAB), deeplab_vars("batch"))):
        back = export_flax_params(load_flax_params(model, tree))
        want = flat(tree)
        got = flat(back)
        assert got.keys() == want.keys()
        for path, leaf in want.items():
            np.testing.assert_array_equal(got[path], leaf, err_msg="/".join(path))


def test_deeplab_training_steps_match_jax(tmp_path, monkeypatch, deeplab_vars):
    """Two ``ranger`` updates of the narrow DeepLabV3+ at 64², GroupNorm: the
    JAX trainer's loss function and optimizer (as ``train_bev`` builds them)
    against the port's ``make_bev_loss_fn`` / ``make_bev_optimizer_fn``."""
    opt = dict(name="ranger", lr=1e-3, weight_decay=0.01, clip_norm=5.0, grad_accum=1, total_steps=2)
    common = dict(model="unet_reference", model_kwargs={"wf": 2, "depth": 1}, bev_shape=(64, 64, 3),
                  batch_size=2)
    jexp = JBEVExperiment(**common, optimizer=JOptimizerConfig(**opt), model_dir=str(tmp_path / "j"))
    exp = BEVExperiment(**common, optimizer=OptimizerConfig(**opt), model_dir=str(tmp_path / "t"))
    pieces = jax_training_pieces(jexp, tmp_path, monkeypatch)
    jm = JDeepLab(n_classes=10, dtype=jnp.float32, **DEEPLAB)
    variables = deeplab_vars("group")
    jtr = jtrainer.Trainer(jm, pieces["tx"], pieces["loss_fn"],
                           jtrainer.TrainerConfig(model_dir=str(tmp_path / "jrun"), donate_state=False))
    jstate = jtrainer.TrainState.create(jax.tree_util.tree_map(jnp.asarray, variables), jtr.tx)

    model = load_flax_params(DeepLabV3Plus(n_classes=10, **DEEPLAB), variables)
    optimizer_fn = tbev_train.make_bev_optimizer_fn(exp)
    trainer = Trainer(model, optimizer_fn, tbev_train.make_bev_loss_fn(exp, "cpu"),
                      TrainerConfig(model_dir=str(tmp_path / "trun")))
    state = TrainState(model, optimizer_fn)
    for step in range(2):
        batch = bev_batch(step, hw=64)
        jstate, jmet = jtr._step_fn(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                                    jax.random.PRNGKey(step))
        state, tmet = trainer.step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "ce", "bce", "dice", "aux"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), rtol=1e-5, err_msg=f"step {step} {k}")
    got, start = flat(export_flax_params(model)["params"]), flat(variables["params"])
    still = []
    for path, want in flat(jax.device_get(jstate.params)["params"]).items():
        moved = np.abs(want - start[path]).max()
        if moved <= 1e-6:
            still.append(path)
        np.testing.assert_allclose(got[path], want, atol=2e-2 * moved + 1e-6, rtol=0,
                                   err_msg="/".join(path))
    # The pooled ASPP branch normalises one value a group: its GroupNorm gives
    # the bias, 0 at init, and ReLU's gradient at 0 is 0, so that bias stays.
    assert still == [("ASPP_0", "ConvNormAct_4", "GroupNorm_0", "bias")]
