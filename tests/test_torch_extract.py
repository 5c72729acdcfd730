"""Port parity: connected components, opening and box extraction of
``lyft3d_tpu_torch.ops`` against the JAX ops on the same inputs.

Labels, masks, validity, pixel counts and detect flags must be exactly
equal. Boxes, centroids and scores must agree to 1e-5: the port keeps XLA's
rounding wherever a decision depends on it (see ``ops/mask_to_boxes.py``),
and what is left is last-bit differences in the final box corner rotation
and in exp/softmax. Inputs whose foreground test sits within 1e-4 of the
threshold in logit space are rejected up front, so that a last-bit
difference in logsumexp cannot flip a pixel by chance.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from lyft3d_tpu.ops import connected_components as jcc
from lyft3d_tpu.ops import mask_to_boxes as jmb
from lyft3d_tpu_torch.ops import connected_components as tcc
from lyft3d_tpu_torch.ops import mask_to_boxes as tmb

TOL = 1e-5
BG_T = 80.0 / 255.0

# The JAX ops, jitted: one compile per shape instead of one per op.
_EXTRACT_ARGS = ("max_components", "max_pixels", "min_pixels")
j_components = jax.jit(jcc.connected_components, static_argnames=("sweeps", "compress_rounds"))
j_open = jax.jit(jcc.morph_open)
j_boxes = jax.jit(jmb.mask_to_rotated_boxes, static_argnames=_EXTRACT_ARGS)
j_extract = jax.jit(jmb.extract_detections, static_argnames=_EXTRACT_ARGS[:1])
j_extract_logits = jax.jit(jax.vmap(jmb.extract_detections_from_logits))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_boxes_equal(jax_out, torch_out):
    """jax_out / torch_out: (boxes, valid, counts, centroids) per batch."""
    jb, jv, jc, jcen = (np.asarray(a) for a in jax_out)
    tb, tv, tc, tcen = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tb, jb, atol=TOL, rtol=0)
    np.testing.assert_allclose(tcen, jcen, atol=TOL, rtol=0)


def assert_detections_equal(jd, td):
    jd = jax.device_get(jd)
    td = {k: v.numpy() for k, v in td.items()}
    assert set(jd) == set(td)
    for k in ("box_valid", "detect", "counts"):
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    for k in ("boxes_px", "centroids", "scores"):
        np.testing.assert_allclose(td[k], jd[k], atol=TOL, rtol=0, err_msg=k)


# -- the cases of tests/test_mask_to_boxes.py ---------------------------------


def _masks():
    two = np.zeros((16, 16), bool)
    two[2:5, 2:5] = True
    two[10:14, 9:15] = True
    diag = np.zeros((8, 8), bool)
    for i in range(6):
        diag[i, i] = True
    snake = np.zeros((20, 20), bool)
    for r in range(20):
        snake[r, :] = True
        if r % 2 == 0:
            snake[r, 0] = snake[r, 1] = False if r > 0 else snake[r, 0]
    snake[0, :] = True
    speck = np.zeros((12, 12), bool)
    speck[3, 3] = True
    speck[6:10, 6:10] = True
    square = np.zeros((16, 16), bool)
    square[4:12, 4:12] = True
    return {
        "two_blobs": two, "diagonal": diag, "snake": snake,
        "empty": np.zeros((8, 8), bool), "speck": speck, "square": square,
    }


MASKS = _masks()


@pytest.mark.parametrize("name", list(MASKS))
@pytest.mark.parametrize("sweeps,rounds", [(64, 0), (16, 6)], ids=["sweeps", "compress"])
def test_connected_components(name, sweeps, rounds):
    fg = MASKS[name]
    want = np.asarray(j_components(jnp.asarray(fg), sweeps=sweeps, compress_rounds=rounds))
    got = tcc.connected_components(t(fg[None]), sweeps=sweeps, compress_rounds=rounds)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("name", list(MASKS))
def test_morph_open(name):
    fg = MASKS[name]
    want = np.asarray(j_open(jnp.asarray(fg)))
    np.testing.assert_array_equal(tcc.morph_open(t(fg[None]))[0].numpy(), want)


def _rect_masks():
    axis = np.zeros((32, 32), bool)
    axis[4:10, 6:18] = True
    rr, cc = np.mgrid[0:48, 0:48]
    u, v = (cc - 24) + (rr - 24), (cc - 24) - (rr - 24)
    rotated = (np.abs(u) <= 16) & (np.abs(v) <= 6)
    multi = np.zeros((64, 64), bool)
    for i in range(5):
        r, c = 3 + 12 * i, 5 + 11 * i
        multi[r:r + 4, c:c + 6] = True
    single = np.zeros((16, 16), bool)
    single[3, 3] = True
    return {
        "axis_aligned": (axis, {}),
        "rotated_45": (rotated, {"max_pixels": 2048}),
        "capacity": (multi, {"max_components": 8}),
        "min_pixels": (single, {"min_pixels": 2}),
        # 40x40 = 1600 px > max_pixels: the box uses the first 1024 in pixel order.
        "over_max_pixels": (np.pad(np.ones((40, 40), bool), 8), {"max_pixels": 1024}),
    }


RECTS = _rect_masks()


@pytest.mark.parametrize("name", list(RECTS))
def test_mask_to_rotated_boxes(name):
    fg, kw = RECTS[name]
    want = j_boxes(jnp.asarray(fg), **kw)
    got = tmb.mask_to_rotated_boxes(t(fg[None]), **kw)
    assert_boxes_equal([a[None] for a in jax.device_get(want)], got)


def test_extract_detections_probs():
    probs = np.zeros((32, 32, 4), np.float32)
    probs[..., 0] = 1.0
    probs[8:14, 8:20, 0] = 0.05
    probs[8:14, 8:20, 2] = 0.9
    probs[8:14, 8:20, 1] = 0.05
    empty = np.zeros((32, 32, 4), np.float32)
    empty[..., 0] = 1.0
    for p in (probs, empty):
        want = j_extract(jnp.asarray(p), max_components=8)
        got = tmb.extract_detections(t(p[None]), max_components=8)
        assert_detections_equal({k: v[None] for k, v in jax.device_get(want).items()}, got)


def test_logits_path_case():
    rng = np.random.RandomState(5)
    logits = rng.randn(48, 48, 5).astype(np.float32)
    logits[8:14, 8:16, :] = -3.0
    logits[8:14, 8:16, 1] = 4.0
    logits[30:36, 20:24, :] = -3.0
    logits[30:36, 20:24, 3] = 4.0
    assert_margin(logits[None])
    want = jax.jit(jmb.extract_detections_from_logits, static_argnames=_EXTRACT_ARGS[:1])(
        jnp.asarray(logits), max_components=8)
    got = tmb.extract_detections_from_logits(t(logits[None]), max_components=8)
    assert_detections_equal({k: v[None] for k, v in jax.device_get(want).items()}, got)


# -- batches of rotated blobs -------------------------------------------------


def blob_logits(seed, batch, hw, n_classes, n_blobs_range=(10, 60)):
    """Background-dominated logits with rotated rectangular blobs of random
    classes, sizes and angles (some touching, some crossing the border)."""
    rng = np.random.RandomState(seed)
    logits = rng.uniform(-1.0, 0.5, (batch, hw, hw, n_classes)).astype(np.float32)
    logits[..., 0] += 5.0
    rr, cc = np.mgrid[0:hw, 0:hw].astype(np.float32)
    for b in range(batch):
        for _ in range(rng.randint(*n_blobs_range)):
            cy, cx = rng.uniform(0, hw, 2)
            half_l, half_w = rng.uniform(1.0, 9.0), rng.uniform(0.7, 3.5)
            a = rng.uniform(0, math.pi)
            u = (cc - cx) * math.cos(a) + (rr - cy) * math.sin(a)
            v = -(cc - cx) * math.sin(a) + (rr - cy) * math.cos(a)
            inside = (np.abs(u) <= half_l) & (np.abs(v) <= half_w)
            cls = rng.randint(1, n_classes)
            logits[b][inside, 0] -= 7.0
            logits[b][inside, cls] += 5.0
    return logits


def logit_margin(logits):
    lf = logits.astype(np.float64)
    m = lf.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(lf - m).sum(-1, keepdims=True)))[..., 0]
    return np.abs(lf[..., 0] - lse - np.log1p(-BG_T))


def assert_margin(logits):
    assert logit_margin(logits).min() >= 1e-4, "input too close to the fg threshold"


@pytest.mark.parametrize("seed", [0, 1])
def test_blob_batch_extraction(seed):
    logits = blob_logits(seed, batch=3, hw=96, n_classes=10)
    assert_margin(logits)
    want = j_extract_logits(jnp.asarray(logits))
    got = tmb.extract_detections_from_logits(t(logits))
    assert_detections_equal(want, got)
    assert got["box_valid"].sum(1).min() >= 5  # the blobs were found

    # The foreground masks before and after the opening are equal too.
    lf = jnp.asarray(logits)
    jfg = (lf[..., 0] - jax.nn.logsumexp(lf, axis=-1)) < jnp.log1p(-BG_T)
    tl_ = t(logits)
    tfg = (tl_[..., 0] - torch.logsumexp(tl_, -1)) < float(torch.log1p(torch.tensor(-BG_T)))
    np.testing.assert_array_equal(tfg.numpy(), np.asarray(jfg))
    np.testing.assert_array_equal(
        tcc.morph_open(tfg).numpy(), np.asarray(jax.jit(jax.vmap(jcc.morph_open))(jfg))
    )
