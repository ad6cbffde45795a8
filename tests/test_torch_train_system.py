"""Port parity and behaviour: the training driver (``launch/train.py``),
the data pipeline (``train/data.py``), checkpoints (``train/checkpoint.py``)
and the fault-tolerance decision layer (``distributed/fault_tolerance.py``)
on ``reduced()`` configs (CPU).

``train_loop`` against the reference's on the reference's batches and
initial state (the port's ``batch_at`` and ``init_train_state``
monkeypatched): eight steps' losses agree to atol 1e-5 (measured <=
1.5e-6). The rest mirrors ``tests/test_train_system.py`` and
``tests/test_fault_tolerance.py`` on the port, where a restart is exact
bit for bit, and holds the checkpoint layout to the reference's: either
package restores the other's float32 checkpoint.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import train as JLT
from repro.train import checkpoint as JC
from repro.train import data as JD
from repro.train import optimizer as JO
from repro.train import train_step as JT
from repro_torch import interop
from repro_torch.configs import get_config as tget
from repro_torch.distributed.fault_tolerance import (FailureKind, Policy,
                                                     StepWatchdog,
                                                     action_for, classify)
from repro_torch.launch import train as TLT
from repro_torch.train import checkpoint as TC
from repro_torch.train import data as TD
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TT

QUIET = dict(log=lambda *_: None, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    cfg = tget("yi-9b").reduced()
    data = TD.DataConfig(batch_size=4, seq_len=64, vocab_size=cfg.vocab_size,
                         seed=3)
    opt = TO.OptimizerConfig(peak_lr=1e-3, warmup_steps=5, total_steps=60)
    return cfg, data, opt


@pytest.fixture
def deterministic():
    """Deterministic algorithms for the test: the embedding's backward
    (``index_put_`` with accumulate) adds in a thread-dependent order on
    the CPU otherwise, so two runs from one seed differ in their last
    bits."""
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def _leaves(state):
    return dict(TC._leaves(state))


def _same(a, b):
    """Two train states equal bit for bit, leaf for leaf, dtypes too."""
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


@pytest.mark.parametrize("arch", ["yi-9b", "moonshot-v1-16b-a3b"])
def test_train_loop_matches_reference(arch, monkeypatch):
    dkw = dict(batch_size=4, seq_len=64, vocab_size=512, seed=3)
    okw = dict(peak_lr=1e-3, warmup_steps=5, total_steps=60)
    jcfg, tcfg = jget(arch).reduced(), tget(arch).reduced()
    want = JLT.train_loop(jcfg, JD.DataConfig(**dkw),
                          JO.OptimizerConfig(**okw),
                          JLT.RunConfig(steps=8, log_every=1),
                          log=lambda *_: None)

    def ref_batch(cfg, step, device):
        return {k: torch.tensor(np.asarray(v), device=device) for k, v in
                JD.batch_at(JD.DataConfig(**dkw), step).items()}

    def ref_init(cfg, *, seed, device):
        js = JT.init_train_state(jax.random.PRNGKey(seed), jcfg)
        return interop.train_state_from_numpy(js.params, js.opt, cfg,
                                              device=device)

    monkeypatch.setattr(TLT, "batch_at", ref_batch)
    monkeypatch.setattr(TT, "init_train_state", ref_init)
    lines = []
    got = TLT.train_loop(tcfg, TD.DataConfig(**dkw),
                         TO.OptimizerConfig(**okw),
                         TLT.RunConfig(steps=8, log_every=3),
                         log=lines.append, device="cpu")
    assert set(got) == set(want) == {"final_loss", "history", "stragglers",
                                     "state"}
    np.testing.assert_allclose(got["history"], want["history"], atol=1e-5)
    assert got["final_loss"] == got["history"][-1]
    assert got["stragglers"] == want["stragglers"] == 0
    # logged at every log_every-th step and the last
    assert [int(s.split()[1]) for s in lines] == [0, 3, 6, 7]
    assert all(s.startswith("step ") and " loss " in s and " gnorm " in s
               and " lr " in s and s.endswith("ms") for s in lines)


def test_loss_decreases(tiny):
    cfg, data, opt = tiny
    out = TLT.train_loop(cfg, data, opt, TLT.RunConfig(steps=40), **QUIET)
    first = np.mean(out["history"][:5])
    last = np.mean(out["history"][-5:])
    assert last < first - 0.5, (first, last)


def test_checkpoint_restart_is_exact(tiny, tmp_path, deterministic):
    """Kill-and-resume at step 20 reproduces the uninterrupted run bit for
    bit: losses, parameters, moments and step."""
    cfg, data, opt = tiny
    full = TLT.train_loop(cfg, data, opt,
                          TLT.RunConfig(steps=30, ckpt_every=10,
                                        ckpt_dir=str(tmp_path / "a")),
                          **QUIET)
    d2 = str(tmp_path / "b")
    TLT.train_loop(cfg, data, opt,
                   TLT.RunConfig(steps=20, ckpt_every=10, ckpt_dir=d2),
                   **QUIET)
    lines = []
    resumed = TLT.train_loop(cfg, data, opt,
                             TLT.RunConfig(steps=30, ckpt_every=10,
                                           ckpt_dir=d2),
                             log=lines.append, device="cpu")
    assert lines[0].startswith("[resume] restored step 20 (loss was ")
    assert resumed["history"] == full["history"][20:]
    assert resumed["final_loss"] == full["final_loss"]
    _same(resumed["state"], full["state"])
    assert all(p.requires_grad
               for p in resumed["state"].params.parameters())


def test_checkpoint_atomicity(tiny, tmp_path):
    cfg, *_ = tiny
    state = TT.init_train_state(cfg, device="cpu")
    d = str(tmp_path / "ck")
    TC.save(d, 1, state)
    TC.save(d, 2, state)
    assert TC.latest_step(d) == 2
    # no tmp litter after successful saves
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    restored, step, _ = TC.restore(d, TLT._template(cfg), device="cpu")
    assert step == 2
    _same(restored, state)


def test_checkpoint_write_failure_leaves_no_litter(tiny, tmp_path,
                                                   monkeypatch):
    cfg, *_ = tiny
    state = TT.init_train_state(cfg, device="cpu")
    d = str(tmp_path / "ck")
    TC.save(d, 1, state)

    def fail(*args, **kwargs):
        raise OSError("no space left on device")

    # the archive is written leaf by leaf: fail on the second leaf
    real = np.lib.format.write_array
    calls = []

    def fail_later(*args, **kwargs):
        calls.append(1)
        if len(calls) > 1:
            fail()
        return real(*args, **kwargs)

    monkeypatch.setattr(np.lib.format, "write_array", fail_later)
    with pytest.raises(OSError):
        TC.save(d, 2, state)
    assert sorted(os.listdir(d)) == ["step_00000001"]
    assert classify(OSError("no space left")) == FailureKind.CHECKPOINT_IO


def test_checkpoint_rejects_mismatched_template(tiny, tmp_path):
    cfg, *_ = tiny
    state = TT.init_train_state(cfg, device="cpu")
    d = str(tmp_path / "ck2")
    TC.save(d, 1, state)
    other = tget("starcoder2-7b").reduced()
    with pytest.raises(ValueError, match="checkpoint/template mismatch"):
        TC.restore(d, TLT._template(other))
    # same names, another shape
    with pytest.raises(ValueError, match="shape"):
        TC.restore(d, TLT._template(dataclasses.replace(cfg, d_ff=128)))


def test_checkpoint_prune_keeps_latest(tiny, tmp_path):
    cfg, *_ = tiny
    state = TT.init_train_state(cfg, device="cpu")
    d = str(tmp_path / "ck3")
    for s in range(1, 7):
        TC.save(d, s, state, keep=3)
    kept = sorted(f for f in os.listdir(d) if f.startswith("step_"))
    assert len(kept) == 3
    assert kept[-1] == "step_00000006"
    assert TC.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        TC.restore(str(tmp_path / "none"), state)


def test_bfloat16_checkpoint_round_trip_is_bit_exact(tmp_path):
    """bfloat16 parameters (stored as their 16-bit patterns), float32
    moments after a step, and the step."""
    cfg = dataclasses.replace(tget("minicpm3-4b").reduced(),
                              dtype="bfloat16")
    state = TT.init_train_state(cfg, seed=1, device="cpu")
    batch = TD.batch_at(TD.DataConfig(batch_size=2, seq_len=16,
                                      vocab_size=cfg.vocab_size), 0,
                        device="cpu")
    state, _ = TT.make_train_step(cfg, TO.OptimizerConfig(warmup_steps=1))(
        state, batch)
    d = str(tmp_path / "bf16")
    TC.save(d, 1, state, metadata={"arch": cfg.name})
    with open(os.path.join(d, "step_00000001", "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["dtypes"][".params/embed"] == "bfloat16"
    assert manifest["dtypes"][".opt/.mu/embed"] == "float32"
    with np.load(os.path.join(d, "step_00000001", "arrays.npz")) as data:
        assert data[".params/embed"].dtype == np.int16
    restored, step, meta = TC.restore(d, TLT._template(cfg), device="cpu")
    assert step == 1 and meta == {"arch": cfg.name}
    assert restored.params.embed.dtype == torch.bfloat16
    _same(restored, state)


def test_checkpoints_cross_between_packages(tmp_path):
    """The same layout: the port restores the reference's float32
    checkpoint (unstacked layers) as ``train_state_from_numpy`` would
    convert it, and the reference restores the port's."""
    jcfg, tcfg = jget("minicpm3-4b").reduced(), tget("minicpm3-4b").reduced()
    js = JT.init_train_state(jax.random.PRNGKey(0), jcfg)
    js = js._replace(opt=js.opt._replace(step=js.opt.step + 3))
    JC.save(str(tmp_path / "ref"), 3, js)
    got, step, _ = TC.restore(str(tmp_path / "ref"), TLT._template(tcfg),
                              device="cpu")
    assert step == 3 and got.opt.step == 3
    _same(got, interop.train_state_from_numpy(js.params, js.opt, tcfg,
                                              device="cpu"))

    ts = TT.init_train_state(tcfg, seed=2, device="cpu")
    TC.save(str(tmp_path / "port"), 5, ts)
    back, step, _ = JC.restore(str(tmp_path / "port"), jax.eval_shape(
        lambda: JT.init_train_state(jax.random.PRNGKey(0), jcfg)))
    assert step == 5 and int(back.opt.step) == 0
    _same(interop.train_state_from_numpy(back.params, back.opt, tcfg,
                                         device="cpu"), ts)


def test_data_stream_deterministic_and_seekable():
    cfg = TD.DataConfig(batch_size=2, seq_len=16, vocab_size=64, seed=1)
    b1 = TD.batch_at(cfg, 17, device="cpu")
    b2 = TD.batch_at(cfg, 17, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = TD.batch_at(cfg, 18, device="cpu")
    assert not torch.equal(b1["tokens"], b3["tokens"])
    # labels are next-token shifted
    assert b1["tokens"].shape == b1["labels"].shape == (2, 16)
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    stream = TD.stream(cfg, start_step=17, device="cpu")
    assert torch.equal(next(stream)["labels"], b1["labels"])
    assert torch.equal(next(stream)["labels"], b3["labels"])


def test_data_follows_the_noisy_recurrence():
    """Without noise each row is t_{i+1} = (31 t_i + 7) mod V; with the
    default 10 % noise about that share of positions breaks it."""
    clean = TD.DataConfig(batch_size=8, seq_len=64, vocab_size=512,
                          p_noise=0.0)
    b = TD.batch_at(clean, 0, device="cpu")
    assert torch.equal(b["labels"], (b["tokens"] * 31 + 7) % 512)
    assert b["tokens"].dtype == torch.int64
    noisy = TD.batch_at(TD.DataConfig(batch_size=8, seq_len=64,
                                      vocab_size=512), 0, device="cpu")
    broken = float(((noisy["tokens"] * 31 + 7) % 512
                    != noisy["labels"]).float().mean())
    assert 0.1 < broken < 0.3            # a replaced token breaks 2 links
    assert int(noisy["tokens"].max()) < 512


def test_straggler_watchdog_counts_slow_steps(tiny):
    cfg, data, opt = tiny
    lines = []
    out = TLT.train_loop(cfg, data, opt,
                         TLT.RunConfig(steps=3, step_timeout_s=0.0),
                         log=lines.append, device="cpu")
    assert out["stragglers"] == 3
    assert sum(s.startswith("[watchdog] step ") for s in lines) == 3


def test_entry_points_default_to_the_gpu(tiny):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg, data, opt = tiny
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLT.train_loop(cfg, data, opt, TLT.RunConfig(steps=1),
                       log=lambda *_: None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TD.batch_at(data, 0)


def test_mesh_is_not_ported(tiny):
    """The mesh is ported (``tests/test_torch_dist_train.py``); what is
    not a ``DeviceMesh`` is refused."""
    cfg, data, opt = tiny
    with pytest.raises(TypeError, match="DeviceMesh"):
        TLT.train_loop(cfg, data, opt, TLT.RunConfig(steps=1), mesh=object(),
                       **QUIET)


def test_cli_smoke_run(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "src"),
         os.environ.get("PYTHONPATH", "")]))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "yi-9b", "--smoke", "--steps", "3", "--device", "cpu"]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=120, check=True).stdout.splitlines()
    assert [s.split()[:2] for s in out[:-1]] == [["step", "0"],
                                                ["step", "2"]]
    result = json.loads(out[-1])
    assert math.isfinite(result["final_loss"]) and result["stragglers"] == 0
    ck = str(tmp_path / "ck")
    subprocess.run(cmd + ["--ckpt-dir", ck, "--ckpt-every", "2"],
                   capture_output=True, text=True, env=env, timeout=120,
                   check=True)
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000003"]


# tests/test_fault_tolerance.py's policy tests on the port's copy.

def test_classify_failures():
    assert classify(ValueError("loss is NaN")) == FailureKind.NAN_LOSS
    assert classify(RuntimeError("device lost: slice 3 halted")) \
        == FailureKind.DEVICE_LOST
    assert classify(OSError("no space left")) == FailureKind.CHECKPOINT_IO
    assert classify(TimeoutError("collective timed out")) \
        == FailureKind.STEP_TIMEOUT


def test_every_failure_kind_has_an_action():
    for kind in FailureKind:
        assert len(action_for(kind)) > 10


def test_watchdog_flags_stragglers():
    wd = StepWatchdog(Policy(straggler_grace=2.0))
    for _ in range(10):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)
    assert wd.flagged == 1
    assert not wd.observe(1.1)
