"""Port parity: ``lyft3d_tpu_torch.train.optim`` against the JAX package's
optax chains, update by update.

From equal float32 parameters and equal gradients (a seeded sequence, with
one large gradient so that the clip bites), 12 updates of every optimizer
``build_optimizer`` knows, with and without the global-norm clip and with
``grad_accum=2``. Tolerance: 1e-6 of the parameters' scale (their largest
magnitude, about 2.6) after every update: bias corrections and schedules are
computed in double here and in float32 by optax, a few float32 roundings a
step. Schedules are compared value by value at 1e-6 relative.

RAdam's rectification term ``ro = ro_inf − 2·t·b2^t / (1 − b2^t)`` cancels
badly in float32 at the default ``b2 = 0.999`` (``1 − b2^t`` is about 0.006
at the sixth step, where rectification starts at ``ro ≈ 5``), so optax's own
float32 value of it carries an error of about 1e-2 there. The port computes
it in double. ``radam`` and ``ranger`` are therefore held to 1e-6 at
``b2 = 0.9``, where the term is well conditioned, and to 2e-5 of scale at
the default (seen: 1e-5).
"""

import numpy as np
import jax.numpy as jnp
import optax
import pytest
import torch

from lyft3d_tpu.train import optim as joptim
from lyft3d_tpu_torch.train import optim as toptim

STEPS = 12
TOL = 1e-6
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}


def _sequence(seed=0):
    rng = np.random.RandomState(seed)
    params = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    grads = []
    for i in range(STEPS):
        scale = 40.0 if i == 3 else 1.0  # one step well above clip_norm
        grads.append({k: (rng.randn(*s) * scale).astype(np.float32) for k, s in SHAPES.items()})
    return params, grads


def _run_both(name, clip_norm, grad_accum, total_steps=10, lr=3e-2, weight_decay=0.01, tol=TOL, **kw):
    params, grads = _sequence()
    scale = max(float(np.abs(v).max()) for v in params.values())
    tx = joptim.build_optimizer(name, lr, total_steps=total_steps, weight_decay=weight_decay,
                                clip_norm=clip_norm, grad_accum=grad_accum, **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.build_optimizer(list(tp.values()), name, lr, total_steps=total_steps,
                                 weight_decay=weight_decay, clip_norm=clip_norm, grad_accum=grad_accum, **kw)
    for i, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k in SHAPES:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=tol * scale,
                                       rtol=0, err_msg=f"{name} step {i} leaf {k}")
    moved = max(float(np.abs(tp[k].detach().numpy() - params[k]).max()) for k in SHAPES)
    assert moved > 1e-3
    return opt


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["every_step", "grad_accum2"])
@pytest.mark.parametrize("clip_norm", [None, 5.0], ids=["noclip", "clip5"])
@pytest.mark.parametrize("name", ["adam_onecycle", "adam", "adamw", "sgd"])
def test_optimizer_matches_optax_update_by_update(name, clip_norm, grad_accum):
    _run_both(name, clip_norm, grad_accum)


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["every_step", "grad_accum2"])
@pytest.mark.parametrize("clip_norm", [None, 5.0], ids=["noclip", "clip5"])
@pytest.mark.parametrize("b2,tol", [(0.9, TOL), (0.999, 2e-5)], ids=["b2_0.9", "b2_default"])
@pytest.mark.parametrize("name", ["radam", "ranger"])
def test_rectified_optimizer_matches_optax_update_by_update(name, b2, tol, clip_norm, grad_accum):
    _run_both(name, clip_norm, grad_accum, tol=tol, b2=b2)


def test_adam_one_cycle_with_its_own_clip_matches_optax():
    """``build_optimizer`` does not hand ``clip_norm`` to ``adam_onecycle``
    in either package; ``adam_one_cycle(clip_norm=…)`` clips in front."""
    params, grads = _sequence(1)
    tx = joptim.adam_one_cycle(3e-2, 10, weight_decay=0.01, clip_norm=5.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = toptim.adam_one_cycle(list(tp.values()), 3e-2, 10, weight_decay=0.01, clip_norm=5.0)
    unclipped = toptim.adam_one_cycle([torch.nn.Parameter(p.detach().clone()) for p in tp.values()],
                                      3e-2, 10, weight_decay=0.01)
    for g in grads:
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for opt_i in (opt, unclipped):
            for p, k in zip(opt_i.param_groups[0]["params"], SHAPES):
                p.grad = torch.from_numpy(g[k].copy())
            opt_i.step()
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=3 * TOL, rtol=0)
    diff = max(float((a - b).detach().abs().max()) for a, b in
               zip(opt.param_groups[0]["params"], unclipped.param_groups[0]["params"]))
    assert diff > 1e-4  # the clip changed the run


def test_lookahead_syncs_on_every_sixth_step_counted_from_one():
    p = torch.nn.Parameter(torch.ones(3))
    opt = toptim.lookahead(toptim.ChainOptimizer([p], "sgd", 0.1), sync_period=6, slow_step=0.5)
    seen = []
    for _ in range(12):
        p.grad = torch.ones(3)
        opt.step()
        seen.append(float(p[0]))
    # Five fast steps of −0.1, then the sixth lands halfway back to the slow weights.
    np.testing.assert_allclose(seen[:6], [0.9, 0.8, 0.7, 0.6, 0.5, 0.7], atol=1e-6)
    np.testing.assert_allclose(seen[11], 0.7 - 0.3, atol=1e-6)


@pytest.mark.parametrize("which", ["one_cycle", "one_cycle_momentum", "cosine_warm_restarts",
                                   "cosine_warm_restarts_tmult2"])
def test_schedules_match_optax(which):
    if which == "one_cycle":
        js, ts = joptim.one_cycle(0.003, 37, 0.4), toptim.one_cycle(0.003, 37, 0.4)
    elif which == "one_cycle_momentum":
        js, ts = joptim.one_cycle_momentum(37, 0.4), toptim.one_cycle_momentum(37, 0.4)
    elif which == "cosine_warm_restarts":
        js, ts = joptim.cosine_warm_restarts(0.01, 5, cycles=4), toptim.cosine_warm_restarts(0.01, 5, cycles=4)
    else:
        js = joptim.cosine_warm_restarts(0.01, 3, t_mult=2, cycles=3, min_scale=0.1)
        ts = toptim.cosine_warm_restarts(0.01, 3, t_mult=2, cycles=3, min_scale=0.1)
    for step in range(45):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=1e-9, err_msg=str(step))


def test_state_dict_round_trip_resumes_the_same_run():
    """Moments, counters and slow weights all travel through ``state_dict``."""
    params, grads = _sequence(2)

    def fresh():
        tp = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in params.values()]
        return tp, toptim.build_optimizer(tp, "ranger", 1e-2, clip_norm=5.0, grad_accum=2, weight_decay=0.01)

    def feed(tp, opt, gs):
        for g in gs:
            for p, k in zip(tp, SHAPES):
                p.grad = torch.from_numpy(g[k].copy())
            opt.step()

    tp1, opt1 = fresh()
    feed(tp1, opt1, grads)
    tp2, opt2 = fresh()
    feed(tp2, opt2, grads[:7])
    tp3, opt3 = fresh()
    opt3.load_state_dict(opt2.state_dict())
    for p3, p2 in zip(tp3, tp2):
        p3.data.copy_(p2.data)
    feed(tp3, opt3, grads[7:])
    for a, b in zip(tp1, tp3):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())


def test_unknown_optimizer_raises():
    with pytest.raises(KeyError):
        toptim.build_optimizer([torch.nn.Parameter(torch.zeros(1))], "lion", 1e-3)
