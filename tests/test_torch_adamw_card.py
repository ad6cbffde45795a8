"""On the card: the multi-tensor AdamW kernel (``csrc/adamw.cu``) against
the eager loop (``optimizer.adamw_update_eager``). Run on a GPU with
``python3 -m pytest -q --noconftest -m card tests/test_torch_adamw_card.py``
(``--noconftest``: ``tests/conftest.py`` imports JAX, which the GPU
machine need not have; this file imports none). Without CUDA they skip.

Given the same gradient norm, the eager loop's clip scale and the
kernel's are the same float32 operations, and so are the update's: the
kernel rounds each step as torch's CUDA kernels do (``__f*_rn``, no
contraction, division by a host scalar as a product with its float32
reciprocal, bf16 by round-to-nearest-even). So parameters and moments are
held bit for bit, with no ulp allowed. The eager loop is handed the
kernel's norm (``global_norm`` patched), since the two sum the squares in
different orders; the kernel's norm is held bit for bit to its plain model
(``kernels/adamw.global_norm_plain``, the same order in plain torch) and
to 1e-5 relative of the float64 norm. DTensor leaves on a CUDA mesh take
the update alone, after the DTensors' own norm, so they are held bit for
bit to the eager loop on the same DTensors, norm included.
"""
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import adamw as KA
from repro_torch.train import optimizer as O

# Leaf sizes: one element, a ragged group, a norm's scale, a leaf of a
# ragged chunk, several whole chunks, and a large ragged one.
SIZES = (1, 7, 2560, 2 ** 20 + 3, 3 * KA.CHUNK, 5_000_011)

# (parameter dtypes in turn, gradient scale, element offset of every leaf
# of p, m and v into a larger buffer: 0 plain tensors, 3 an unaligned head,
# None p shifted alone so that no group is aligned). A gradient scale of
# 1e-4 keeps the norm under clip_norm 1.0; 1e-2 is clipped.
CASES = {
    "bf16_unclipped": ((torch.bfloat16,), 1e-4, 0),
    "bf16_clipped": ((torch.bfloat16,), 1e-2, 0),
    "float32_unclipped": ((torch.float32,), 1e-4, 0),
    "float32_clipped": ((torch.float32,), 1e-2, 0),
    "bf16_with_float32_router": ((torch.bfloat16, torch.float32), 1e-2, 0),
    "bf16_unaligned_head": ((torch.bfloat16,), 1e-2, 3),
    "bf16_no_common_alignment": ((torch.bfloat16,), 1e-2, None),
}
STEPS = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaf(n, dtype, offset, dev, gen, std, square=False):
    """A leaf of n values drawn with ``std`` (squared with ``square``): a
    plain tensor (offset 0) or a view ``offset`` elements into a
    buffer."""
    x = torch.randn(n, generator=gen, device=dev) * std
    x = (x.square() if square else x).to(dtype)
    if offset == 0:
        return x
    buf = torch.zeros(n + 8, dtype=dtype, device=dev)
    buf[offset:offset + n] = x
    return buf[offset:offset + n]


def _state(case, dev, seed):
    dtypes, _, offset = CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, mu, nu = {}, {}, {}
    for i, n in enumerate(SIZES):
        dtype = dtypes[i % len(dtypes)]
        params[f"l{i}"] = _leaf(n, dtype, 1 if offset is None else offset,
                                dev, gen, 1.0)
        mu[f"l{i}"] = _leaf(n, torch.float32, offset or 0, dev, gen, 1e-3)
        nu[f"l{i}"] = _leaf(n, torch.float32, offset or 0, dev, gen, 1e-3,
                            square=True)
    return params, O.OptState(step=4, mu=mu, nu=nu)


def _grads(case, params, dev, seed):
    _, scale, _ = CASES[case]
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: (torch.randn(p.shape, generator=gen, device=dev)
                * scale).to(p.dtype) for k, p in params.items()}


def _clone(tree):
    return {k: t.clone() for k, t in tree.items()}


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32))


def _f64_norm(grads):
    return math.sqrt(sum(float(g.double().square().sum())
                         for g in grads.values()))


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_eager_loop(case, cuda, monkeypatch):
    """Three steps from the same state: the kernel through
    ``adamw_update`` (three launches, the eager loop never called) and the
    eager loop handed the kernel's norm give the same bits in every
    parameter and moment; the norm is the plain model's, bit for bit, and
    within 1e-5 of float64; clipping engages where the case says."""
    cfg = O.OptimizerConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    params, opt = _state(case, cuda, seed=1)
    eager_p = _clone(params)
    eager = O.OptState(opt.step, _clone(opt.mu), _clone(opt.nu))
    real_eager = O.adamw_update_eager
    for step in range(STEPS):
        grads = _grads(case, params, cuda, seed=10 + step)
        heads = [min(KA.head([t.data_ptr() for t in (p, grads[k], opt.mu[k],
                                                     opt.nu[k])],
                             (p.element_size(),) * 2 + (4, 4)), p.numel())
                 for k, p in params.items()]
        assert KA.route(grads, params, opt.mu, opt.nu) == "kernel"
        before = KA._LAUNCHES.value
        monkeypatch.setattr(O, "adamw_update_eager",
                            lambda *a: pytest.fail("the eager loop ran"))
        _, opt, metrics = O.adamw_update(grads, opt, params, cfg)
        monkeypatch.setattr(O, "adamw_update_eager", real_eager)
        assert KA._LAUNCHES.value - before == KA.LAUNCHES
        norm = metrics["grad_norm"]
        assert norm.device.type == "cuda" and norm.dtype == torch.float32
        want = KA.global_norm_plain([grads[k] for k in params], heads)
        assert _same_bits(norm, want.to(cuda)), (float(norm), float(want))
        assert float(norm) == pytest.approx(_f64_norm(grads), rel=1e-5)
        assert (float(norm) > cfg.clip_norm) == (CASES[case][1] > 1e-3)

        monkeypatch.setattr(O, "global_norm", lambda tree: norm)
        _, eager, em = O.adamw_update_eager(grads, eager, eager_p, cfg)
        monkeypatch.undo()
        assert em["lr"] == metrics["lr"] and eager.step == opt.step
        for k in params:
            for got, ref, what in ((params[k], eager_p[k], "p"),
                                   (opt.mu[k], eager.mu[k], "m"),
                                   (opt.nu[k], eager.nu[k], "v")):
                assert _same_bits(got, ref), (
                    step, k, what, int((got != ref).sum()),
                    float((got.float() - ref.float()).abs().max()))


@pytest.mark.card
def test_two_calls_are_bit_equal(cuda):
    """The same state and gradients twice: the same norm, parameters and
    moments, bit for bit (no atomics)."""
    cfg = O.OptimizerConfig(warmup_steps=1)
    outs = []
    for _ in range(2):
        params, opt = _state("bf16_with_float32_router", cuda, seed=2)
        grads = _grads("bf16_with_float32_router", params, cuda, seed=3)
        _, opt, metrics = O.adamw_update(grads, opt, params, cfg)
        outs.append((metrics["grad_norm"], params, opt))
    (n1, p1, o1), (n2, p2, o2) = outs
    assert _same_bits(n1, n2)
    for k in p1:
        assert _same_bits(p1[k], p2[k])
        assert _same_bits(o1.mu[k], o2.mu[k])
        assert _same_bits(o1.nu[k], o2.nu[k])


@pytest.mark.card
@pytest.mark.parametrize("what", ["float16", "gradient_float32",
                                  "not_contiguous"])
def test_the_card_refuses_what_the_kernel_does_not_take(what, cuda):
    """Plain CUDA leaves the kernel does not take raise ``ValueError``
    before any launch, and nothing changes."""
    params, opt = _state("bf16_unclipped", cuda, seed=4)
    grads = _grads("bf16_unclipped", params, cuda, seed=5)
    if what == "float16":
        params = {k: p.half() for k, p in params.items()}
        grads = {k: g.half() for k, g in grads.items()}
    elif what == "gradient_float32":
        grads["l2"] = grads["l2"].float()
    else:
        params["l2"] = params["l2"].reshape(40, 64).t().contiguous().t()
        grads["l2"] = grads["l2"].reshape(40, 64)
        opt.mu["l2"] = opt.mu["l2"].reshape(40, 64)
        opt.nu["l2"] = opt.nu["l2"].reshape(40, 64)
    before_p = _clone(params)
    before = KA._LAUNCHES.value
    with pytest.raises(ValueError):
        O.adamw_update(grads, opt, params, O.OptimizerConfig())
    assert KA._LAUNCHES.value == before
    assert all(_same_bits(params[k], before_p[k]) for k in params)


@pytest.mark.card
def test_the_update_advances_version_counters(cuda):
    """The kernel writes through raw pointers; the wrapper advances the
    parameters' and moments' version counters as an in-place torch
    operation does, so autograd sees the change."""
    params, opt = _state("bf16_with_float32_router", cuda, seed=6)
    grads = _grads("bf16_with_float32_router", params, cuda, seed=7)
    before = {k: [t[k]._version for t in (params, opt.mu, opt.nu)]
              for k in params}
    O.adamw_update(grads, opt, params, O.OptimizerConfig(warmup_steps=1))
    for k in params:
        after = [t[k]._version for t in (params, opt.mu, opt.nu)]
        assert all(a > b for a, b in zip(after, before[k])), (k, after)


@pytest.mark.card
@pytest.mark.parametrize("placement", ["replicate", "shard"])
def test_dtensor_leaves_take_the_kernel_update(placement, cuda):
    """DTensor leaves on a CUDA mesh of one rank (an NCCL group of world
    size 1, in a process of its own) route to ``"mesh"``: one launch (the
    update on the local tensors), the eager loop never called, and the
    same bits as the eager loop on the same DTensors in the norm, every
    parameter and both moments, over three steps."""
    code = r"""
import os, sys, tempfile, torch, torch.distributed as dist
dist.init_process_group(
    "nccl", store=dist.FileStore(os.path.join(tempfile.mkdtemp(), "s"), 1),
    rank=0, world_size=1, device_id=torch.device("cuda", 0))
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels import adamw as KA
from repro_torch.train import optimizer as O
mesh = init_device_mesh("cuda", (1,))
place = [Shard(0) if sys.argv[1] == "shard" else Replicate()]
gen = torch.Generator(device="cuda").manual_seed(8)
shapes = (((640, 4), torch.bfloat16), ((2 ** 20 + 3,), torch.bfloat16),
          ((9,), torch.float32), ((33, 70), torch.float32))
local = {f"l{i}": (torch.randn(s, generator=gen, device="cuda")).to(d)
         for i, (s, d) in enumerate(shapes)}
def tree(src):
    return {k: DTensor.from_local(t.clone(), mesh, place)
            for k, t in src.items()}
p, q = tree(local), tree(local)
opt, ref = O.init_opt_state(p), O.init_opt_state(q)
cfg = O.OptimizerConfig(peak_lr=1e-3, warmup_steps=1)
def bits(x):
    x = x.to_local() if isinstance(x, DTensor) else x
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)
real = O.adamw_update_eager
for step in range(3):
    gl = {k: (torch.randn(t.shape, generator=gen, device="cuda")
              * 10 ** -step).to(t.dtype) for k, t in local.items()}
    g, h = tree(gl), tree(gl)
    assert KA.route(g, p, opt.mu, opt.nu) == "mesh"
    before = KA._LAUNCHES.value
    O.adamw_update_eager = lambda *a: sys.exit("the eager loop ran")
    _, opt, got = O.adamw_update(g, opt, p, cfg)
    O.adamw_update_eager = real
    assert KA._LAUNCHES.value - before == 1
    _, ref, want = O.adamw_update_eager(h, ref, q, cfg)
    assert torch.equal(bits(got["grad_norm"]), bits(want["grad_norm"]))
    for k in local:
        for a, b in ((p[k], q[k]), (opt.mu[k], ref.mu[k]),
                     (opt.nu[k], ref.nu[k])):
            assert torch.equal(bits(a), bits(b)), (step, k)
dist.destroy_process_group()
print("ok")
"""
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [src] + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run([sys.executable, "-c", code, placement], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), \
        proc.stdout + proc.stderr
