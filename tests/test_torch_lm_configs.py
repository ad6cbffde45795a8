"""Port parity: the LM harness's configs (``configs/``) and activation
hooks (``models/sharding_hooks.py``) against the JAX reference.

Configs are plain dataclasses on both sides, so every field, derived
property and parameter count agrees exactly, for the four registered
archs at their published widths and for their ``reduced()`` configs."""
import dataclasses

import pytest
import torch

from repro import configs as jconfigs
from repro.models import sharding_hooks as jhooks
from repro_torch import configs as tconfigs
from repro_torch.models import sharding_hooks as thooks

ARCHS = list(jconfigs.ARCH_IDS)


@pytest.fixture(autouse=True)
def _reset_hooks():
    """``set_hooks`` is process-global in both packages."""
    jhooks.set_hooks({})
    thooks.set_hooks({})
    yield
    jhooks.set_hooks({})
    thooks.set_hooks({})


def _assert_same_config(t, j):
    assert [f.name for f in dataclasses.fields(t)] == \
        [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("resolved_head_dim", "d_inner", "ssm_heads"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count() == j.param_count()
    assert t.active_param_count() == j.active_param_count()


def test_registry_ids_equal():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS


@pytest.mark.parametrize("arch", ARCHS)
def test_published_config_equal(arch):
    _assert_same_config(tconfigs.get_config(arch), jconfigs.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_equal(arch):
    t = tconfigs.get_config(arch).reduced()
    _assert_same_config(t, jconfigs.get_config(arch).reduced())
    assert tconfigs.get_config(arch + "-smoke") == t
    assert t.dtype == "float32" and not t.scan_layers


def test_yi_9b_published_width():
    """The width phase 6 of chip_smoke.py serves: 8.83 B parameters."""
    cfg = tconfigs.get_config("yi-9b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.resolved_head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == \
        (48, 4096, 32, 4, 128, 11008, 64000, "bfloat16")
    assert cfg.param_count() == 8_829_009_920


def test_shapes_and_applicability_equal():
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == \
        [dataclasses.asdict(s) for s in jconfigs.SHAPES]
    for arch in ARCHS:
        for ts, js in zip(tconfigs.SHAPES, jconfigs.SHAPES):
            assert tconfigs.shape_applicable(tconfigs.get_config(arch), ts) \
                == jconfigs.shape_applicable(jconfigs.get_config(arch), js)
            assert tconfigs.get_shape(ts.name).tokens == js.tokens


def test_unknown_ids_raise():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("llama-70b")
    # The renderer's own config is an extra id, as in the reference.
    got, want = tconfigs.get_config("lsgaussian"), \
        jconfigs.get_config("lsgaussian")
    assert type(got).__name__ == type(want).__name__ == "RendererArch"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert tconfigs.EXTRA_IDS == jconfigs.EXTRA_IDS
    with pytest.raises(KeyError):
        tconfigs.get_shape("train_8k")


def test_constrain_is_identity_without_a_hook():
    x = torch.randn(2, 3)
    assert thooks.constrain(x, "residual") is x
    thooks.set_hooks({"attn_impl": "flash"})
    assert thooks.constrain(x, "residual") is x


def test_constrain_refuses_a_sharding_hook():
    thooks.set_hooks({"residual": object()})
    with pytest.raises(ValueError, match="'residual'.*not a DTensor"):
        thooks.constrain(torch.zeros(1), "residual")


def test_hooks_and_flags_behave_as_reference():
    for hooks in (jhooks, thooks):
        table = {"attn_impl": "sdpa", "causal_skip": True}
        hooks.set_hooks(table)
        table["attn_impl"] = "flash"                  # set_hooks copies
        got = hooks.get_hooks()
        got["causal_skip"] = False                    # get_hooks copies
        assert hooks.get_flag("attn_impl", "auto") == "sdpa"
        assert hooks.get_flag("causal_skip", False) is True
        assert hooks.get_flag("other", 7) == 7
        hooks.set_hooks(None)
        assert hooks.get_hooks() == {}
        assert hooks.get_flag("attn_impl", "auto") == "auto"
