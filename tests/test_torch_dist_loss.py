"""Port parity: the cross-entropy on a (2, 2) mesh (``train_step.
cross_entropy(..., sharding=)``) against one device and the JAX
reference, on four CPU ranks (gloo).

Logits (B, S, V) placed batch over "data" and, where it divides, vocab
over "model": the loss within 1e-5 and the logits' gradient within 1e-6
of the port's single-device loss and the reference's ``jax.grad`` of its
``cross_entropy``, with and without a mask. The gradient keeps the
logits' placements, each rank holding (B/2, S, V/2) where the vocab is
split and (B/2, S, V) where it is not (V odd), and no op on any rank
makes a plain tensor as large as the global (B, S, V) logits, forward
or backward. On one rank, the per-shard function equals the one-device
NLL in float32 and bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_workers as W
from repro.train import train_step as JT
from repro_torch.train import train_step as TT

B, S = 4, 6
CASES = {"split": (64, True, False), "split_masked": (64, True, True),
         "batch_only": (63, False, False),
         "batch_only_masked": (63, False, True)}


def _inputs(v, masked, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(B, S, v)) * 3).astype(np.float32)
    labels = rng.integers(0, v, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32) if masked else None
    return logits, labels, mask


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload = {}
    for i, (name, (v, split, masked)) in enumerate(CASES.items()):
        logits, labels, mask = _inputs(v, masked, i)
        payload[name] = dict(logits=logits, labels=labels, mask=mask,
                             split=split)
    job = W.Spawned(W.loss_worker, 4, tmp_path_factory.mktemp("loss"),
                    payload)
    want = {}
    for name, case in payload.items():
        x = torch.tensor(case["logits"], requires_grad=True)
        m = None if case["mask"] is None else torch.tensor(case["mask"])
        loss = TT.cross_entropy(x, torch.tensor(case["labels"]), m)
        loss.backward()
        jm = None if case["mask"] is None else jnp.asarray(case["mask"])
        jloss, jgrad = jax.value_and_grad(
            lambda z: JT.cross_entropy(z, jnp.asarray(case["labels"]), jm))(
                jnp.asarray(case["logits"]))
        want[name] = {"port": (float(loss.detach()), x.grad.numpy()),
                      "jax": (float(jloss), np.asarray(jgrad))}
    return job.result(), want


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_loss_and_gradient_equal_one_device(runs, name):
    got, want = runs
    g = got[name]
    for other in ("port", "jax"):
        loss, grad = want[name][other]
        print(name, other, abs(g["loss"] - loss),
              np.abs(g["grad"] - grad).max())
        assert abs(g["loss"] - loss) <= 1e-5, (other, g["loss"], loss)
        np.testing.assert_allclose(g["grad"], grad, rtol=0, atol=1e-6,
                                   err_msg=other)


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_gradient_stays_local(runs, name):
    got, _ = runs
    v, split, _ = CASES[name]
    g = got[name]
    vocab = "S(2)" if split else "R"
    print(name, g["grad_placements"], g["grad_local"], g["largest"])
    assert g["is_dtensor"]
    assert g["grad_placements"] == ("S(0)", vocab)
    assert g["grad_local"] == (B // 2, S, v // 2 if split else v)
    assert g["largest"][0] < B * S * v, g["largest"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shard_nll_on_one_rank_equals_nll(dtype):
    """The per-rank function with the whole vocab and no group against
    the one-device ``_nll`` on the same logits: the NLL within 1e-5, the
    gradient (in the logits' dtype; entries in [-1, 1]) within 1e-6 in
    float32 and one bf16 epsilon in bf16."""
    logits, labels, _ = _inputs(37, False, 7)
    x = torch.tensor(logits).to(dtype).requires_grad_()
    y = torch.tensor(labels)
    got = TT._ShardNLL.apply(x, y, None, 0)
    (g,) = torch.autograd.grad(got.sum(), x)
    want = TT._nll(x, y)
    (w,) = torch.autograd.grad(want.sum(), x)
    assert got.dtype == want.dtype == torch.float32 and g.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
    atol = 1e-6 if dtype == torch.float32 else torch.finfo(dtype).eps
    torch.testing.assert_close(g.float(), w.float(), rtol=0, atol=atol)
