"""A driver that renders nothing: its own check through the harness, the
``lm_train`` driver on the port's train step against the plain reference
at the ``-smoke`` size on the CPU, and faults that read not correct."""
import dataclasses
import sys
import types

import pytest
import torch

from lsbench import harness, lm_train, peaks, stream, venue
from lsbench.tests.lm_tiny import LIMITS, run_tiny_lm, tiny_lm


def _kind(monkeypatch, value):
    mod = types.ModuleType("lsbench.own_check")
    mod.run = lambda cell: dict(e2e=dict(setup_s=1.0), attempted=3,
                                failed=0, memory_peak_bytes=0, obs={},
                                kept=value)
    mod.numbers = lambda cell, out: {"gap": out["kept"]}
    monkeypatch.setitem(sys.modules, "lsbench.own_check", mod)
    bench, cfg, mix = tiny_lm()
    return bench, cfg, dict(mix, kind="own_check")


@pytest.mark.parametrize("value,ok", [(0.5, True), (2.0, False)])
def test_a_driver_with_numbers_is_judged_by_them(monkeypatch, value, ok):
    bench, cfg, mix = _kind(monkeypatch, value)
    res = harness.run_cell(bench, "moonshot-v1-16b-a3b-smoke.train", 1, 0.1,
                           False, "cpu", 0.0, cfg=cfg, traffic=mix,
                           limits={"gap": 1.0})
    assert res["correct"] is ok
    assert res["checks"] == {"gap": {"value": value, "limit": 1.0}}
    assert set(res["metrics"]) == {"setup_s"}


def test_renderer_drivers_keep_the_frame_check():
    assert not hasattr(stream, "numbers") and not hasattr(venue, "numbers")
    from lsbench.tests.tiny import run_tiny
    res = run_tiny("tandt-train.walk")
    assert list(res["checks"]) == ["key_px", "warp_px", "pairs", "ldu"]


@pytest.mark.parametrize("changes", [
    {},                                  # every choice kept (dropless)
    {"seq_len": 300},                    # capacity round(600 / 8 * 1.25)
], ids=["dropless", "capacity"])
def test_sound_training_run_is_correct(changes):
    res = run_tiny_lm(**changes)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(LIMITS)
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_dense_training_run_is_correct():
    res = run_tiny_lm("yi-9b")
    assert res["correct"], res["checks"]


def test_tokens_dropped_past_capacity_are_held_to_the_reference(monkeypatch):
    """At a capacity factor of 1 a row's choices overflow their experts;
    the reference drops the same ones."""
    from repro_torch.configs import base
    real = base.ArchConfig.reduced

    def tight(self):
        return dataclasses.replace(real(self), moe_capacity_factor=1.0)

    monkeypatch.setattr(base.ArchConfig, "reduced", tight)
    res = run_tiny_lm(seq_len=300)
    assert res["correct"], res["checks"]


def _scaled_loss(monkeypatch):
    from repro_torch.train import train_step as T
    real = T.make_train_step

    def make(cfg, opt, mesh=None):
        step = real(cfg, opt, mesh)

        def scaled(state, batch):
            state, metrics = step(state, batch)
            return state, dict(metrics, loss=metrics["loss"] * 1.001)
        return scaled

    monkeypatch.setattr(T, "make_train_step", make)


def _one_update_altered(monkeypatch):
    from repro_torch.train import train_step as T
    real = T.adamw_update

    def altered(grads, opt, params, cfg):
        out = real(grads, opt, params, cfg)
        with torch.no_grad():
            params["layers.1.attn.wo"].mul_(1.001)
        return out

    monkeypatch.setattr(T, "adamw_update", altered)


def _in_bfloat16(monkeypatch):
    from repro_torch.train import train_step as T
    real_init, real_make = T.init_train_state, T.make_train_step

    def bf16(cfg):
        return dataclasses.replace(cfg, dtype="bfloat16")

    monkeypatch.setattr(T, "init_train_state",
                        lambda cfg, **kw: real_init(bf16(cfg), **kw))
    monkeypatch.setattr(T, "make_train_step",
                        lambda cfg, opt, mesh=None: real_make(bf16(cfg), opt,
                                                              mesh))


def _state_unchanged(monkeypatch):
    from repro_torch.train import train_step as T
    real = T.adamw_update

    def skipped(grads, opt, params, cfg):
        saved = {k: p.detach().clone() for k, p in params.items()}
        out = real(grads, opt, params, cfg)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
        return out

    monkeypatch.setattr(T, "adamw_update", skipped)


def _half_the_batch(monkeypatch):
    from repro_torch.train import train_step as T
    real = T.cross_entropy

    def half(logits, labels, mask=None, sharding=None):
        b = logits.shape[0] // 2
        return real(logits[:b], labels[:b], None, sharding)

    monkeypatch.setattr(T, "cross_entropy", half)


@pytest.mark.parametrize("fault", [_scaled_loss, _one_update_altered,
                                   _in_bfloat16, _state_unchanged,
                                   _half_the_batch],
                         ids=["loss_scaled", "one_update_altered",
                              "bfloat16", "state_unchanged",
                              "half_the_batch"])
def test_faults_read_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    res = run_tiny_lm()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("precision", ["bfloat16", "float8"])
def test_lower_precision_reference_fails_the_limits(precision):
    """The control's machinery: the reference one precision down, in the
    program's place, reads past the limits."""
    bench, cfg, mix = tiny_lm()
    cell = harness.make_cell(bench, "moonshot-v1-16b-a3b-smoke.train", 5,
                             0.1, False, "cpu", 0.0, cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    layout = out["check"]["layout"]
    got = lm_train.compare(lm_train.follow(cell, layout, precision),
                           lm_train.follow(cell, layout, "float32"))
    assert any(got[k] > lim for k, lim in LIMITS.items()), got


def test_traced_run_gives_the_readers_their_obs():
    from lsbench import devtrace
    bench, cfg, mix = tiny_lm()
    cell = harness.make_cell(bench, "moonshot-v1-16b-a3b-smoke.train", 5,
                             0.2, True, "cpu", 0.0, cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    obs = out["obs"]
    assert obs["kind"] == "lm_train"
    assert isinstance(obs["slice"], devtrace.Slice)
    assert obs["traced_steps"] == mix["trace_steps"]
    assert obs["flops_per_step"] == peaks.lm_train_flops(
        cfg["arch"], mix["sequences_per_step"], mix["seq_len"])
    assert obs["tokens_per_step"] == 80 and len(obs["step_seconds"]) >= 1
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_draws():
    layout = [("embed", (16, 8), torch.float32),
              ("layers.0.moe.w_in", (4, 8, 6), torch.bfloat16),
              ("layers.0.ln1", (8,), torch.float32)]
    a = dict(lm_train.weights(layout, 2 ** 31 + 11, "cpu"))
    b = dict(lm_train.weights(layout, 2 ** 31 + 11, "cpu"))
    c = dict(lm_train.weights(layout, 2 ** 31 + 12, "cpu"))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers.0.moe.w_in"].dtype == torch.bfloat16
    assert torch.equal(a["layers.0.ln1"], torch.ones(8))
    mix = dict(sequences_per_step=3, seq_len=5)
    x = lm_train.batch(2 ** 31 + 11, 4, mix, 50, "cpu")
    y = lm_train.batch(2 ** 31 + 11, 4, mix, 50, "cpu")
    assert torch.equal(x["tokens"], y["tokens"])
    assert torch.equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert len({tuple(r.tolist()) for r in x["tokens"]}) == 3


@pytest.mark.parametrize("arch", ["yi-9b", "starcoder2-7b", "minicpm3-4b",
                                  "moonshot-v1-16b-a3b"])
def test_flops_count_the_weights_a_token_meets(arch):
    """6 per weight a token multiplies by (the port's own count of active
    parameters less the embedding lookup) plus causal attention."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    a = dataclasses.asdict(cfg)
    lookup = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model
    assert peaks.lm_matmul_params(a) == cfg.active_param_count() - lookup
    s, b = 4096, 2
    qk = (cfg.nope_head_dim + cfg.rope_head_dim if cfg.attention == "mla"
          else cfg.resolved_head_dim)
    v = cfg.v_head_dim if cfg.attention == "mla" else cfg.resolved_head_dim
    attn = 3 * 2 * cfg.num_heads * b * s * (s + 1) / 2 * (qk + v) \
        * cfg.num_layers
    assert peaks.lm_train_flops(a, b, s) == pytest.approx(
        6 * peaks.lm_matmul_params(a) * b * s + attn)


def test_control_gives_the_check_numbers():
    """``control`` (read by ``calibrate.py``) holds the reference one
    precision below the configuration's to the float32 one; on the CPU
    TF32 is float32, so float32's control reads round-off only."""
    bench, cfg, mix = tiny_lm()
    cell = harness.make_cell(bench, "moonshot-v1-16b-a3b-smoke.train", 6,
                             0.1, False, "cpu", 0.0, cfg=cfg, traffic=mix)
    out = harness.drive(cell)
    assert lm_train.CONTROL[cfg["arch"]["dtype"]] == "tf32"
    got = lm_train.control(cell, out)
    assert set(got) == set(LIMITS) and max(got.values()) < 1e-5
    assert set(harness.numbers(cell, out)) == set(LIMITS)
