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
import math
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as JO
from repro_torch.train import optimizer as TO

SRC = Path(__file__).resolve().parents[1] / "src"

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


# -- the multi-tensor kernel's route, chunks and norm order ---------------
# The kernel itself runs only on the card (tests/test_torch_adamw_card.py);
# here its route, its leaf table's chunking and the order of its norm, all
# of which are plain Python, are held on the CPU.

from repro_torch.kernels import adamw as KA  # noqa: E402,I100


def _state(dtypes, device="cpu", shapes=((7, 5), (33,), (4, 3, 2))):
    """(params, grads, OptState) of seeded leaves, one a shape, dtypes in
    turn; made under whatever mode is active (fake CUDA tensors too)."""
    gen = torch.Generator().manual_seed(3)

    def draw(shape, dtype):
        if device == "cuda":                        # fake: no values
            return torch.empty(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=gen).to(dtype).to(device)

    params, grads = {}, {}
    for i, shape in enumerate(shapes):
        dtype = dtypes[i % len(dtypes)]
        params[f"l{i}"] = draw(shape, dtype)
        grads[f"l{i}"] = draw(shape, dtype)
    return params, grads, TO.init_opt_state(params)


def _launches():
    return KA._LAUNCHES.value


EAGER_ROUTE_CASES = {
    "cpu_bf16": (torch.bfloat16,),
    "cpu_float32": (torch.float32,),
    "cpu_mixed_router": (torch.bfloat16, torch.float32),
    "meta_bf16": (torch.bfloat16,),
}


@pytest.mark.parametrize("case", sorted(EAGER_ROUTE_CASES))
def test_adamw_route_takes_the_eager_loop(case, monkeypatch):
    """CPU and meta leaves take the eager loop (called once, with the
    caller's arguments) and launch nothing."""
    dtypes = EAGER_ROUTE_CASES[case]
    device = "meta" if case.startswith("meta") else "cpu"
    params, grads, opt = _state(dtypes, device)
    cfg = TO.OptimizerConfig(warmup_steps=1)
    calls = []
    real = TO.adamw_update_eager

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(TO, "adamw_update_eager", spy)
    before = _launches()
    assert KA.route(grads, params, opt.mu, opt.nu) == "eager"
    _, new_opt, metrics = TO.adamw_update(grads, opt, params, cfg)
    assert len(calls) == 1 and calls[0][0] is grads and calls[0][2] is params
    assert new_opt.step == 1 and metrics["grad_norm"].device.type == device
    assert _launches() == before


def test_adamw_route_takes_the_eager_loop_for_dtensors():
    """DTensor leaves (on a fake group of one rank, in a process of their
    own: a fake group may not share one with a real one) take the eager
    loop: ``refusal`` names the device, nothing is launched, and the
    update equals the eager loop's on the plain local tensors."""
    import subprocess
    import sys
    code = r"""
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.kernels import adamw as KA
from repro_torch.train import optimizer as O
mesh = init_device_mesh("cpu", (1,))
gen = torch.Generator().manual_seed(5)
local = {k: torch.randn(s, generator=gen).to(d) for k, s, d in
         (("a", (6, 4), torch.bfloat16), ("b", (9,), torch.float32))}
grad = {k: torch.randn(t.shape, generator=gen).to(t.dtype)
        for k, t in local.items()}
def dt(tree):
    return {k: DTensor.from_local(t.clone(), mesh, [Replicate()])
            for k, t in tree.items()}
p, g = dt(local), dt(grad)
opt = O.init_opt_state(p)
cfg = O.OptimizerConfig(warmup_steps=1, peak_lr=1e-2)
assert KA.route(g, p, opt.mu, opt.nu) == "eager"
assert "devices" in KA.refusal(g, p, opt.mu, opt.nu)
before = KA._LAUNCHES.value
O.adamw_update(g, opt, p, cfg)
assert KA._LAUNCHES.value == before
plain = {k: t.clone() for k, t in local.items()}
popt = O.init_opt_state(plain)
O.adamw_update_eager(grad, popt, plain, cfg)
for k in local:
    assert torch.equal(p[k].to_local(), plain[k]), k
    assert torch.equal(opt.mu[k].to_local(), popt.mu[k]), k
    assert torch.equal(opt.nu[k].to_local(), popt.nu[k]), k
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", \
        proc.stdout + proc.stderr


# DTensor leaves on a CUDA mesh (fake CUDA tensors counted as plain, on a
# fake group of one rank): what ``route`` gives or the word of its
# ValueError, and for "mesh" what ``adamw_update`` hands the kernel.
MESH_ROUTE_CASES = {
    "replicate": "mesh",
    "shard": "mesh",
    "gradient_placed_apart": "placed otherwise",
    "beside_plain": "DTensors beside plain",
}


@pytest.fixture(scope="module")
def mesh_routes():
    """Every MESH_ROUTE_CASES case, run in one process of its own (a fake
    group may not share one with a real one): {case: what it gave}."""
    import json
    import subprocess
    import sys
    code = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels import adamw as KA
from repro_torch.train import optimizer as O
KA.PLAIN = KA.PLAIN + (FakeTensor,)
mesh = DeviceMesh("cuda", torch.arange(1), _init_backend=False)
out = {}
for case in ("replicate", "shard", "gradient_placed_apart", "beside_plain"):
    pl = Shard(0) if case == "shard" else Replicate()
    with FakeTensorMode():
        def dt(shape, dtype, place=pl):
            return DTensor.from_local(
                torch.empty(shape, dtype=dtype, device="cuda"), mesh, [place])
        shapes = {"a": ((6, 4), torch.bfloat16), "b": ((9,), torch.float32)}
        p = {k: dt(*sd) for k, sd in shapes.items()}
        g = {k: dt(*sd) for k, sd in shapes.items()}
        if case == "gradient_placed_apart":
            g["a"] = dt((6, 4), torch.bfloat16, Shard(1))
        elif case == "beside_plain":
            g["b"] = torch.empty(9, device="cuda")
        opt = O.init_opt_state(p)
        try:
            got = KA.route(g, p, opt.mu, opt.nu)
        except ValueError as e:
            out[case] = str(e)
            continue
        seen = []
        real = KA.adamw
        KA.adamw = lambda gg, pp, mm, vv, k, ns=None: (
            seen.append((gg is g, pp is p, ns)) or ns)
        eager = O.adamw_update_eager
        O.adamw_update_eager = lambda *a: seen.append("eager")
        _, new, metrics = O.adamw_update(g, opt, p, O.OptimizerConfig())
        KA.adamw, O.adamw_update_eager = real, eager
        (same_g, same_p, ns), = seen
        out[case] = [got, same_g, same_p, list(ns.shape), str(ns.dtype),
                     str(ns.device), new.step, type(metrics["grad_norm"])
                     is FakeTensor]
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(MESH_ROUTE_CASES))
def test_adamw_route_for_dtensors_on_the_card(case, mesh_routes):
    """DTensors on a CUDA mesh, placed alike (replicated or sharded),
    route to the kernel's update on their local tensors: ``adamw_update``
    hands it the tree and a float32 pair of the eager path's norm and clip
    scale, and does not call the eager loop. A gradient placed otherwise
    than its parameter, or a DTensor beside a plain tensor, raises
    ``ValueError``."""
    want, got = MESH_ROUTE_CASES[case], mesh_routes[case]
    if want == "mesh":
        assert got == ["mesh", True, True, [2], "torch.float32", "cuda:0",
                       1, True]
    else:
        assert isinstance(got, str) and want in got, got


# (parameter dtypes, what to alter, and what ``route`` gives or the word of
# its ValueError) for plain CUDA tensors
CARD_ROUTE_CASES = {
    "bf16": ((torch.bfloat16,), None, "kernel"),
    "float32": ((torch.float32,), None, "kernel"),
    "bf16_with_float32_router": ((torch.bfloat16, torch.float32), None,
                                 "kernel"),
    "float16": ((torch.float16,), None, "dtype"),
    "gradient_dtype_mixed": ((torch.bfloat16,), "grad_f32", "mixed dtypes"),
    "moments_bf16": ((torch.bfloat16,), "moment_bf16", "mixed dtypes"),
    "not_contiguous": ((torch.bfloat16,), "transposed", "contiguous"),
}


@pytest.mark.parametrize("case", sorted(CARD_ROUTE_CASES))
def test_adamw_route_on_the_card(case, monkeypatch):
    """Plain CUDA leaves (here fake ones counted as plain, since the CPU
    has no card): bfloat16 and float32 parameters with their gradients'
    dtype and float32 moments take the kernel; anything else raises
    ``ValueError`` before any launch and without the eager loop."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    dtypes, alter, want = CARD_ROUTE_CASES[case]
    monkeypatch.setattr(KA, "PLAIN", KA.PLAIN + (FakeTensor,))
    monkeypatch.setattr(TO, "adamw_update_eager",
                        lambda *a: pytest.fail("the eager loop ran"))
    before = _launches()
    with FakeTensorMode():
        params, grads, opt = _state(dtypes, "cuda")
        if alter == "grad_f32":
            grads["l1"] = grads["l1"].float()
        elif alter == "moment_bf16":
            opt.nu["l2"] = opt.nu["l2"].bfloat16()
        elif alter == "transposed":
            params["l0"] = torch.empty((5, 7), dtype=torch.bfloat16,
                                       device="cuda").t()
        if want == "kernel":
            assert KA.route(grads, params, opt.mu, opt.nu) == "kernel"
            assert KA.refusal(grads, params, opt.mu, opt.nu) is None
        else:
            for fn in (KA.route, lambda g, p, m, v: TO.adamw_update(
                    g, TO.OptState(0, m, v), p, TO.OptimizerConfig())):
                with pytest.raises(ValueError, match=want):
                    fn(grads, params, opt.mu, opt.nu)
    assert _launches() == before


# Leaf sizes (the embedding of minicpm3-4b last) and element offsets of
# p, g, m and v from a 16-byte boundary: aligned, all four shifted alike
# (an unaligned head, then an aligned body), and p or g shifted apart (no
# common alignment: every chunk loads element by element).
CHUNK_SIZES = (1, 7, 2560, 2 ** 20 + 3, 188_026_880)
OFFSETS = {"aligned": (0, 0, 0, 0), "shifted": (3, 3, 3, 3),
           "apart": (1, 0, 0, 0), "gradient_apart": (0, 1, 0, 0)}


@pytest.mark.parametrize("offsets", sorted(OFFSETS))
@pytest.mark.parametrize("n", CHUNK_SIZES)
def test_adamw_chunks_cover_every_element_once(n, offsets):
    """The chunks of a leaf tile [0, n) in order, each element once; past
    the head every chunk starts where p, g, m and v are all 16-byte
    aligned (where they can be) and holds CHUNK elements but the last; the
    leaf table's row holds the addresses, the count, the head and the
    dtype."""
    shift = OFFSETS[offsets]
    sizes = (2, 2, 4, 4)                  # bf16 p and g, float32 m and v
    addrs = [4096 + s * z for s, z in zip(shift, sizes)]
    hd = min(KA.head(addrs, sizes), n)
    spans = KA.chunk_spans(n, hd)
    assert len(spans) == KA.chunk_count(n, hd)
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(e > s for s, e in spans)
    body = spans[1:] if hd > 0 else spans
    assert all(e - s == KA.CHUNK for s, e in body[:-1])
    common = "apart" not in offsets
    assert hd == (min((8 - shift[0]) % 8, n) if common else 0)
    if common:
        assert all((a + s * z) % 16 == 0 for s, _ in body
                   for a, z in zip(addrs, sizes))
    if n < 2 ** 21:
        p, g, m, v = (torch.zeros(n + 8, dtype=dt)[s:s + n] for s, dt in
                      zip(shift, (torch.bfloat16, torch.bfloat16,
                                  torch.float32, torch.float32)))
        rows, total = KA.leaf_table({"x": g}, {"x": p}, {"x": m}, {"x": v},
                                    ["x"])
        row_head = KA.head([t.data_ptr() for t in (p, g, m, v)], sizes)
        assert rows.shape == (1, KA.FIELDS)
        assert min(row_head, n) == hd     # the buffers are 64-byte aligned
        assert list(rows[0]) == [p.data_ptr(), m.data_ptr(), v.data_ptr(),
                                 n, 0, hd, 1, g.data_ptr()]
        assert total == KA.chunk_count(n, hd)


# Leaf sizes and dtypes for the norm's order (a ragged chunk and a head
# in each of the larger leaves).
NORM_CASES = {
    "bf16": ([2 ** 16 + 5, 2560, 1, 40_000], torch.bfloat16, 0),
    "float32": ([3 * KA.CHUNK + 17, 7, 999], torch.float32, 0),
    "bf16_heads": ([2 ** 17 + 3, 33, 70_001], torch.bfloat16, 5),
}


@pytest.mark.parametrize("case", sorted(NORM_CASES))
def test_adamw_norm_order_near_float64(case):
    """The kernel's norm in its fixed order, done in plain torch
    (``global_norm_plain``): within 1e-6 relative of the float64 norm,
    and of the eager path's float32 one."""
    sizes, dtype, hd = NORM_CASES[case]
    gen = torch.Generator().manual_seed(11)
    grads = [(torch.randn(n, generator=gen)
              * torch.logspace(-3, 1, n)).to(dtype) for n in sizes]
    got = KA.global_norm_plain(grads, [min(hd, n) for n in sizes])
    want = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(want, rel=1e-6)
    eager = TO.global_norm({str(i): g for i, g in enumerate(grads)})
    assert float(got) == pytest.approx(float(eager), rel=1e-6)
