"""``reference/lm_decoder.py``'s latent attention against the port's
train step at
``minicpm3-4b``'s ``-smoke`` size on the CPU, in float32, and faults of
the MLA training cell that read not correct."""
import dataclasses

import pytest
import torch

from lsbench import harness, lm_train
from lsbench.tests.lm_tiny import LIMITS, run_tiny_lm
from lsbench.tests.test_lsbench_lm_train import (_half_the_batch,
                                                 _in_bfloat16, _scaled_loss,
                                                 _state_unchanged)

ARCH = "minicpm3-4b"


@pytest.mark.parametrize("seq_len", [40, 2048],
                         ids=["materialized", "flash_chunks"])
def test_reference_matches_the_port_leaf_by_leaf(seq_len):
    """The loss and every leaf's gradient of one batch. At 2,048 positions
    the port takes its flash path (chunks of 512 queries and 1,024 keys)
    and the reference its blocks of 1,024 query rows."""
    from repro_torch.configs import get_config
    from repro_torch.train import train_step as T
    cfg = get_config(f"{ARCH}-smoke")
    arch = dataclasses.asdict(cfg)
    state = T.init_train_state(cfg, seed=0, device="cpu")
    params = dict(state.params.named_parameters())
    layout = [(k, tuple(p.shape), p.dtype) for k, p in params.items()]
    with torch.no_grad():
        for name, w in lm_train.weights(layout, 2 ** 31 + 7, "cpu"):
            params[name].copy_(w)
    b = lm_train.batch(2 ** 31 + 7, 0, dict(seq_len=seq_len,
                                            sequences_per_step=2),
                       cfg.vocab_size, "cpu")
    total, metrics = T.make_loss_fn(cfg)(state.params, b)
    grads = dict(zip(params, torch.autograd.grad(total,
                                                 list(params.values()))))
    ref = harness.load("reference", "lm_decoder")
    loss, want = ref.loss_and_grads(
        arch, {k: p.detach().float() for k, p in params.items()},
        b["tokens"], b["labels"])
    # Both sides are float32 and differ only in the order of their sums
    # (the port's concatenated nope and rope scores, flash chunks and
    # fused einsums; the reference's separate products and blocks): they
    # read 1e-7 or less, and a product in bfloat16 reads 1e-4 or more.
    got = float(metrics["loss"].detach())
    assert abs(got - loss) / loss < LIMITS["loss_rel"]
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in want.items()}
    med = sorted(norms.values())[len(norms) // 2]
    assert set(grads) == set(want)
    for k, g in grads.items():
        gap = float(torch.linalg.vector_norm(g - want[k]))
        assert gap / max(norms[k], med) < LIMITS["grad_rel"], k


def test_two_adamw_steps_agree_through_the_harness():
    res = run_tiny_lm(ARCH)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)


def _one_mla_update_altered(monkeypatch):
    from repro_torch.train import train_step as T
    real = T.adamw_update

    def altered(grads, opt, params, cfg):
        out = real(grads, opt, params, cfg)
        with torch.no_grad():
            params["layers.1.attn.w_uq"].mul_(1.001)
        return out

    monkeypatch.setattr(T, "adamw_update", altered)


def _rotary_key_left_out(monkeypatch):
    """The reference scores without the decoupled rotary key: its
    ``w_kr`` is zero, so ``q_rope . kr`` adds nothing."""
    real = harness.load

    def load(sub, name):
        mod = real(sub, name)
        if sub == "reference":
            inner = mod.loss_and_grads

            def without(arch, weights, *args, **kw):
                weights = {k: torch.zeros_like(w) if k.endswith(".w_kr")
                           else w for k, w in weights.items()}
                return inner(arch, weights, *args, **kw)

            mod.loss_and_grads = without
        return mod

    monkeypatch.setattr(harness, "load", load)


def _one_leaf_in_float8(monkeypatch):
    """The program reports one MLA leaf stored in float8 e4m3: the
    reference stores the dtype the configuration states, so this is a
    departure the check counts, not a rounding it follows."""
    real = lm_train.run

    def run(cell):
        out = real(cell)
        layout = out["check"]["layout"]
        at = next(i for i, (k, _, _) in enumerate(layout)
                  if k.endswith(".attn.w_uq"))
        name, shape, _ = layout[at]
        layout[at] = (name, shape, torch.float8_e4m3fn)
        return out

    monkeypatch.setattr(lm_train, "run", run)


@pytest.mark.parametrize("fault", [
    _scaled_loss, _one_mla_update_altered, _in_bfloat16,
    _rotary_key_left_out, _state_unchanged, _half_the_batch,
    _one_leaf_in_float8],
    ids=["loss_scaled", "mla_update_altered", "bfloat16",
         "rotary_key_left_out", "state_unchanged", "half_the_batch",
         "leaf_in_float8"])
def test_mla_faults_read_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny_lm(ARCH)
    assert not res["correct"], res["checks"]


def test_float8_control_fails_the_limits():
    """The cell's control at the test's size: the reference in float8 in
    the program's place reads past the limits."""
    from lsbench.tests.lm_tiny import tiny_lm
    bench, cfg, mix = tiny_lm(ARCH)
    cell = harness.make_cell(bench, f"{ARCH}-smoke.train", 5, 0.1, False,
                             "cpu", 0.0, cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    layout = out["check"]["layout"]
    got = lm_train.compare(lm_train.follow(cell, layout, "float8"),
                           lm_train.follow(cell, layout, "float32"))
    assert any(got[k] > lim for k, lim in LIMITS.items()), got


def test_reference_stores_weights_as_the_program_does():
    """In bfloat16 an update below half a unit in the last place leaves a
    weight where it was: a norm's scale of 1 does not move at this
    learning rate. The reference rounds each update to the stated dtype,
    so both sides leave the same leaves unmoved, and the sound run's
    change reads 0.0025 on seeds 1-3 (the float8 control 0.0075-0.0125)."""
    from lsbench.tests.lm_tiny import tiny_lm
    bench, cfg, mix = tiny_lm(ARCH, seq_len=256)
    cfg["arch"]["dtype"] = "bfloat16"
    cell = harness.make_cell(bench, f"{ARCH}-smoke.train", 2, 0.1, False,
                             "cpu", 0.0, cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    got = out["check"]["record"]
    want = lm_train.follow(cell, out["check"]["layout"], "float32")
    unmoved = {k for k, c in got["change"].items() if c == 0.0}
    assert "final_norm" in unmoved
    assert unmoved == {k for k, c in want["change"].items() if c == 0.0}
    assert lm_train.compare(got, want)["update_rel"] < 0.005
