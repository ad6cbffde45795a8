"""A run whose timed path is broken underneath must come out not correct:
the harness's look for a card is skipped, the rest of a run is driven at
a tiny size on the CPU."""
import pytest

from lsbench.tests.tiny import run_tiny


def test_sound_runs_are_correct():
    assert run_tiny("tandt-train.walk")["correct"]
    assert run_tiny("tandt-train.venue", seconds=1.0)["correct"]


def test_state_returned_unchanged(monkeypatch):
    from repro_torch.core import engine
    real = engine.make_frame_step

    def make(scene, cam, cfg, phase=0):
        step = real(scene, cam, cfg, phase)

        def stale(carry, pose):
            new, (rgb, rec) = step(carry, pose)
            if rec.is_full:
                return new, (rgb, rec)
            # The warped frame shows the previous frame again.
            return new._replace(state=carry.state), (carry.state.rgb, rec)
        return stale

    monkeypatch.setattr(engine, "make_frame_step", make)
    res = run_tiny("tandt-train.walk")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("where", ["render_full_frame",
                                   "render_sparse_frame"])
def test_answer_altered_where_produced(monkeypatch, where):
    from repro_torch.core import engine
    real = getattr(engine, where)

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        first = out[0]
        rgb = first.rgb if hasattr(first, "rgb") else first
        rgb[:16, :16] += 0.05
        return out

    monkeypatch.setattr(engine, where, altered)
    res = run_tiny("tandt-train.walk")
    assert not res["correct"], res["checks"]


def test_half_the_batch_left_out(monkeypatch):
    from repro_torch.core import engine
    real = engine.render_streams

    def half(*args, **kwargs):
        res = real(*args, **kwargs)
        b = res.frames.shape[0]
        res.frames[b // 2:] = 0.0
        return res

    monkeypatch.setattr(engine, "render_streams", half)
    # At the cell's own check: one window for each slot that rendered.
    res = run_tiny("tandt-train.venue", seconds=1.0)
    assert not res["correct"], res["checks"]


def test_binned_counts_moved_between_tiles(monkeypatch):
    """The key frames' counts moved one tile on, their totals kept: the
    LDU is then scheduled from counts no tile of the reference has."""
    from repro_torch.core import engine
    real = engine.make_frame_step

    def make(scene, cam, cfg, phase=0):
        step = real(scene, cam, cfg, phase)

        def moved(carry, pose):
            new, (rgb, rec) = step(carry, pose)
            if not rec.is_full:
                return new, (rgb, rec)
            return new, (rgb, rec._replace(
                sort_pairs=rec.sort_pairs.roll(1)))
        return moved

    monkeypatch.setattr(engine, "make_frame_step", make)
    res = run_tiny("tandt-train.walk")
    assert not res["correct"]
    assert res["checks"]["pairs"]["value"] > res["checks"]["pairs"]["limit"]


def test_checked_windows_cover_every_slot():
    import numpy as np
    import torch
    from types import SimpleNamespace
    from lsbench import venue

    slots = [[0] * 10, [1] * 4 + [0] * 6, [0] * 10, [0] * 5 + [3] * 5]
    served = []
    for k, sl in enumerate(slots):
        poses = np.zeros((10, 4, 4))
        poses[:, 0, 0] = 100 * k + np.arange(10)   # session k, frame i
        served.append(venue.Served(
            SimpleNamespace(phase=k % 5), poses, [0.0] * 10, seen=10,
            capacity=[512] * 10, slots=sl,
            frames=[torch.zeros((10, 2, 2, 3))]))
    for seed in range(20):
        wins = venue.checked_windows(served, 5, np.random.default_rng(seed),
                                     2)
        firsts = [int(w[0]["pose"][0, 0]) for w in wins]
        assert len(wins) >= 2 and len(set(firsts)) == len(wins)
        seen = set()
        for first, w in zip(firsts, wins):
            k, lo = divmod(first, 100)
            assert w[0]["key"] and not any(f["key"] for f in w[1:])
            seen |= set(slots[k][lo:lo + len(w)])
        assert {0, 1, 3} <= seen
