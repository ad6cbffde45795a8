"""Port parity: the sharding rules (``distributed/sharding.py``) against
the JAX reference's, in-process and without a process group.

For each of the four registered configs at full width and depth, every
leaf of the port's ``TrainState`` (built on the ``meta`` device) gets the
reference's spec for the same leaf of its ``TrainState`` (from
``jax.eval_shape`` and ``param_shardings`` on an ``AbstractMesh``), on
six meshes. The reference stacks its layers (a leading L dim, to which
its rules give a leading None); the port's layer i leaf must have the
stacked spec with that entry dropped. The comparison is exact. Batch
and decode-cache trees are checked the same way, and the rules' errors.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCH_IDS
from repro.configs import get_config as jget
from repro.distributed import sharding as JS
from repro.models import model as JM
from repro.train import train_step as JT
from repro_torch.configs import get_config as tget
from repro_torch.distributed import sharding as TS
from repro_torch.launch import train as TLT
from repro_torch.models import model as TM

ARCHS = list(ARCH_IDS)
MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


def _ref_keys(path):
    """A reference key path as strings, like the port's path keys."""
    out = []
    for p in path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                out.append(getattr(p, attr))
                break
    return tuple(out)


def _ref_specs(tree):
    """{key path: spec tuple} of a reference tree of NamedShardings."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {_ref_keys(path): tuple(s.spec) for path, s in flat}


def _port_specs(tree):
    return {path: tuple(spec) for path, spec in TS._leaves(tree)
            if spec is not None}


def _stacked_key(path):
    """A port path with its layer index dropped, and whether it had one."""
    keys = tuple(k for k in path if not isinstance(k, int))
    return keys, len(keys) != len(path)


_REF_STATE = {}


def _ref_state(arch):
    if arch not in _REF_STATE:
        cfg = jget(arch)
        _REF_STATE[arch] = jax.eval_shape(
            lambda: JT.init_train_state(jax.random.PRNGKey(0), cfg))
    return _REF_STATE[arch]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    want = _ref_specs(JS.param_shardings(_ref_state(arch),
                                         AbstractMesh(sizes, names)))
    state = TLT._template(tget(arch))
    got = _port_specs(TS.param_specs(state, dict(zip(names, sizes))))
    seen = set()
    for path, spec in got.items():
        key, layered = _stacked_key(path)
        ref = want[key]
        assert spec == (ref[1:] if layered else ref), (path, spec, ref)
        seen.add(key)
    assert seen == set(want)


def test_every_leaf_is_a_rule_leaf():
    """The port's train state has the reference's leaves, layer by layer:
    three trees (params, mu, nu) of the same names, and the step."""
    for arch in ARCHS:
        cfg = tget(arch)
        state = TLT._template(cfg)
        params = dict(state.params.named_parameters())
        assert list(state.opt.mu) == list(state.opt.nu) == list(params)
        want = _ref_specs(JS.param_shardings(
            _ref_state(arch), AbstractMesh((4, 2), ("data", "model"))))
        stacked = {_stacked_key(("params",) + tuple(TS._keys(k)))[0]
                   for k in params}
        assert stacked == {k for k in want if k[0] == "params"}


@pytest.mark.parametrize("mesh", ["4x2", "1x8", "2x16x16"])
def test_batch_specs_match_reference(mesh):
    sizes, names = MESHES[mesh]
    amesh = AbstractMesh(sizes, names)
    for b in (1, 6, 32, 64):
        ref_batch = {"tokens": jax.ShapeDtypeStruct((b, 128), np.int32),
                     "labels": jax.ShapeDtypeStruct((b, 128), np.int32),
                     "embeds": jax.ShapeDtypeStruct((b, 16, 64), np.float32)}
        want = _ref_specs(JS.batch_shardings(ref_batch, amesh))
        port_batch = {k: torch.empty(v.shape, device="meta")
                      for k, v in ref_batch.items()}
        got = _port_specs(TS.batch_specs(port_batch, dict(zip(names, sizes))))
        assert got == want, (b, got, want)


@pytest.mark.parametrize("mesh", ["4x2", "2x4", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch, mesh):
    sizes, names = MESHES[mesh]
    amesh = AbstractMesh(sizes, names)
    for batch, max_seq in ((16, 512), (1, 4096)):
        ref_cache = jax.eval_shape(
            lambda: JM.init_cache(jget(arch), batch, max_seq))
        want = _ref_specs(JS.cache_shardings(ref_cache, amesh))
        port_cache = TM.init_cache(tget(arch), batch, max_seq, device="meta")
        got = _port_specs(TS.cache_specs(port_cache, dict(zip(names, sizes))))
        assert got == want, (batch, got, want)


def test_rule_errors_match_reference():
    amesh = AbstractMesh((4, 2), ("data", "model"))
    sizes = {"data": 4, "model": 2}
    for tree, err in (({"no_such_leaf": (4, 4)}, KeyError),
                      ({"wq": (4, 4)}, ValueError),
                      ({"embed": (8,)}, ValueError)):
        ref = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in tree.items()}
        with pytest.raises(err):
            JS.param_shardings(ref, amesh)
        with pytest.raises(err):
            TS.param_specs({k: torch.empty(s, device="meta")
                            for k, s in tree.items()}, sizes)


def test_moe_and_shared_expert_rules():
    """``moe`` turns the expert rules on (rank 3), ``shared`` off."""
    sizes = {"data": 2, "model": 4}
    experts = torch.empty((8, 64, 32), device="meta")
    dense = torch.empty((64, 32), device="meta")
    specs = TS.param_specs({"layers.0.moe.w_in": experts,
                            "layers.0.moe.shared.w_in": dense,
                            "layers.0.mlp.w_in": dense,
                            "layers.0.moe.w_out": experts}, sizes)
    assert specs["layers.0.moe.w_in"] == ("model", "data", None)
    assert specs["layers.0.moe.w_out"] == ("model", "data", None)
    assert specs["layers.0.moe.shared.w_in"] == ("data", "model")
    assert specs["layers.0.mlp.w_in"] == ("data", "model")


@pytest.mark.parametrize("mesh", ["4x2", "2x16x16", "8x1"])
def test_specs_and_placements_convert_both_ways(mesh):
    sizes, names = MESHES[mesh]
    ordered = dict(zip(names, sizes))
    state = TLT._template(tget("moonshot-v1-16b-a3b"))
    specs = list(TS._leaves(TS.param_specs(state, ordered)))
    specs += list(TS._leaves(TS.batch_specs(
        {"tokens": torch.empty((64, 8), device="meta")}, ordered)))
    for path, spec in specs:
        placements = TS.to_placements(spec, ordered)
        assert len(placements) == len(names)
        back = TS.to_spec(placements, ordered, len(spec))
        # a size-1 axis holds the whole dim: it is placed Replicate()
        want = tuple(None if e is not None and all(
            ordered[a] == 1 for a in (e if isinstance(e, tuple) else (e,)))
            else e for e in spec)
        assert tuple(back) == want, (path, spec, placements, back)
        assert TS.to_placements(back, ordered) == placements
    # ("pod", "data") on one dim: pod (mesh dim 0) is the major one
    assert TS.to_placements(TS.P(("pod", "data"), None),
                            {"pod": 2, "data": 16, "model": 16}) == (
        TS.Shard(0), TS.Shard(0), TS.Replicate())
    with pytest.raises(ValueError, match="order"):
        TS.to_placements(TS.P(("data", "pod")),
                         {"pod": 2, "data": 16, "model": 16})
    with pytest.raises(ValueError):
        TS.to_placements(TS.P("data", "data"), {"data": 2, "model": 2})


def test_non_divisible_dims_replicate():
    """A dim the axis does not divide is replicated, never uneven."""
    specs = TS.param_specs({"embed": torch.empty((10, 6), device="meta"),
                            "wk": torch.empty((6, 1, 4), device="meta")},
                           {"data": 4, "model": 4})
    assert specs["embed"] == (None, None)
    assert specs["wk"] == (None, None, None)
    specs = TS.param_specs({"embed": torch.empty((12, 8), device="meta")},
                           {"data": 4, "model": 4})
    assert specs["embed"] == ("model", "data")
