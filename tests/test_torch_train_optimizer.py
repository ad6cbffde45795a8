"""Port parity: the optimizer (``train/optimizer.py``) against the JAX
reference (CPU).

The schedule's scalars are float32 on both sides: the port computes them
in numpy on the host, the reference in XLA, whose ``cos`` may differ by
an ulp, so the lr is held to rtol 1e-6. ``global_norm`` sums the leaves
in the same order in float32: rtol 1e-6. ``adamw_update`` follows the
reference op for op on the same inputs: float32 parameters and the
moments agree to rtol 1e-6 (measured: bit-equal on these trees), bfloat16
parameters to one bfloat16 ulp (rtol 2^-7, where a float32 result one
ulp apart rounds the other way)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.train import optimizer as TO

SCHEDULES = {"warmup": dict(peak_lr=1e-3, warmup_steps=5, total_steps=20),
             "launcher": dict(warmup_steps=1, total_steps=3),
             "defaults": dict()}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_schedule_parity(name):
    kw = SCHEDULES[name]
    jcfg, tcfg = JO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)
    steps = list(range(0, tcfg.total_steps + 6)) + [tcfg.warmup_steps - 1,
                                                    tcfg.total_steps // 2]
    for step in steps:
        want = float(JO.lr_schedule(jcfg, jnp.int32(step)))
        got = TO.lr_schedule(tcfg, step)
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=1e-6, abs=0), step


def test_lr_schedule_bounds():
    cfg = TO.OptimizerConfig(peak_lr=3e-4, warmup_steps=100,
                             total_steps=10000)
    for step in np.random.default_rng(0).integers(1, 10 ** 6, 50):
        lr = TO.lr_schedule(cfg, int(min(step, cfg.total_steps)))
        assert 0.0 <= lr <= cfg.peak_lr * (1 + 1e-6)
    assert TO.lr_schedule(cfg, cfg.total_steps) == pytest.approx(
        cfg.peak_lr * cfg.min_lr_ratio, rel=1e-6)


def _tree(seed, dtypes=("float32", "bfloat16")):
    """Seeded {name: numpy array} leaves of several shapes and dtypes, as
    float32 values exactly representable in each leaf's dtype."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (7, 5), "b.c": (33,), "b.d": (4, 3, 2), "e": ()}
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        dtype = dtypes[i % len(dtypes)]
        x = torch.tensor(rng.normal(size=shape).astype(np.float32))
        out[name] = (x.to(getattr(torch, dtype)).float().numpy(), dtype)
    return out


def _jax(tree, scale=1.0):
    return {k: jnp.asarray(v * scale).astype(getattr(jnp, d))
            for k, (v, d) in tree.items()}


def _torch(tree, scale=1.0):
    return {k: torch.tensor(v * scale).to(getattr(torch, d))
            for k, (v, d) in tree.items()}


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("dtypes", [("float32",), ("float32", "bfloat16")])
def test_global_norm_parity(dtypes):
    tree = _tree(1, dtypes)
    want = float(JO.global_norm(_jax(tree)))
    got = TO.global_norm(_torch(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)


# (parameter dtypes, gradient scale): 0.01 stays under clip_norm 1.0, 30
# is clipped.
UPDATE_CASES = {"f32_unclipped": (("float32",), 0.01),
                "f32_clipped": (("float32",), 30.0),
                "bf16_unclipped": (("float32", "bfloat16"), 0.01),
                "bf16_clipped": (("float32", "bfloat16"), 30.0)}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_adamw_update_parity(case):
    """Three updates with other gradients each, clipping off or on: the
    parameters, both moments, the step and the metrics."""
    dtypes, gscale = UPDATE_CASES[case]
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg, tcfg = JO.OptimizerConfig(**kw), TO.OptimizerConfig(**kw)
    p0 = _tree(2, dtypes)
    jp, tp = _jax(p0), _torch(p0)
    jopt, topt = JO.init_opt_state(jp), TO.init_opt_state(tp)
    assert topt.step == 0 and all(m.dtype == torch.float32
                                  for m in topt.mu.values())
    for i in range(3):
        g = _tree(10 + i, dtypes)
        jp, jopt, jm = JO.adamw_update(_jax(g, gscale), jopt, jp, jcfg)
        tp2, topt, tm = TO.adamw_update(_torch(g, gscale), topt, tp, tcfg)
        assert tp2 is tp                                  # in place
        assert topt.step == int(jopt.step) == i + 1
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k, (_, dtype) in p0.items():
            assert tp[k].dtype == getattr(torch, dtype)
            rtol = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
            np.testing.assert_allclose(_f32(tp[k]), _f32(jp[k]), rtol=rtol,
                                       atol=1e-7)
            np.testing.assert_allclose(topt.mu[k].numpy(),
                                       np.asarray(jopt.mu[k]), rtol=1e-6,
                                       atol=1e-9)
            np.testing.assert_allclose(topt.nu[k].numpy(),
                                       np.asarray(jopt.nu[k]), rtol=1e-6,
                                       atol=1e-12)


def test_adamw_moves_toward_gradient():
    params = {"w": torch.ones((4, 4))}
    opt = TO.init_opt_state(params)
    cfg = TO.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                             weight_decay=0.0)
    new_p, new_opt, m = TO.adamw_update({"w": torch.ones((4, 4))}, opt,
                                        params, cfg)
    assert float(new_p["w"].max()) < 1.0          # moved against +grad
    assert new_opt.step == 1
    assert float(m["grad_norm"]) == pytest.approx(4.0)


def test_adamw_clips_grad_norm():
    cfg = TO.OptimizerConfig(peak_lr=1e-2, warmup_steps=1, total_steps=10,
                             clip_norm=1.0, weight_decay=0.0)
    moved = []
    for g in (1e-3, 1e3):
        params = {"w": torch.zeros((8,))}
        p, *_ = TO.adamw_update({"w": torch.full((8,), g)},
                                TO.init_opt_state(params), params, cfg)
        moved.append(float(p["w"].abs().max()))
    # after clipping, the huge-grad step is no bigger than ~the small one
    assert moved[1] <= moved[0] * 1.5 + 1e-8


def test_init_opt_state_takes_a_module():
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    params = M.init_params(get_config("yi-9b").reduced(), device="cpu")
    opt = TO.init_opt_state(params)
    assert list(opt.mu) == [n for n, _ in params.named_parameters()]
    assert all(not m.any() for m in opt.nu.values())
