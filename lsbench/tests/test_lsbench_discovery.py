"""A cell, a configuration, a mix and a metric are added by files and
entries alone: nothing of the harness is edited."""
import json
import shutil

import pytest

from lsbench import check, harness, lm_train
from lsbench.tests.tiny import tiny

READER = '''
def read(obs):
    if obs.get("kind") != "stream":
        return None
    return float(len(obs["slice_frames"]))
'''


def test_new_files_make_a_new_cell(tmp_path, monkeypatch):
    root = tmp_path / "lsbench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(harness.HERE / sub, root / sub)
    bench, cfg, mix = tiny("tandt-train.walk")
    cfg["name"] = "tiny-room"
    (root / "configs" / "tiny-room.json").write_text(json.dumps(cfg))
    mix["why"] = "a slower walk"
    mix["speed_m_s"] = 0.9
    (root / "traffic" / "stroll.json").write_text(json.dumps(mix))
    (root / "metrics" / "slice_frames.stream.py").write_text(READER)
    shutil.copy(root / "limits" / "tandt-train.walk.json",
                root / "limits" / "tiny-room.stroll.json")
    bench["configs"].append({"name": "tiny-room", "source": "test",
                             "file": "lsbench/configs/tiny-room.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-room.stroll",
                               "config": "tiny-room", "traffic": "stroll",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({
        "name": "slice_frames.stream", "unit": "frames", "better": "higher",
        "source": "program_span", "layer": "core.engine",
        "moves": "frames_per_s", "workloads": ["tiny-room.stroll"]})
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(check, "LIMITS", root / "limits")
    res = harness.run_cell(bench, "tiny-room.stroll", 4, 1.0, True, "cpu",
                           0.0)
    assert res["correct"], res["checks"]
    assert res["metrics"]["slice_frames.stream"]["value"] == 10.0


def test_new_files_make_a_training_cell(tmp_path, monkeypatch):
    """A configuration, an ``lm_train`` mix, a reference and limits as
    files, and entries: the line has ``tokens_per_s`` and ``setup_s`` and
    no renderer metric, and a renderer cell's line gains nothing."""
    from lsbench.tests.lm_tiny import LIMITS, tiny_lm
    from lsbench.tests.tiny import tiny as tiny_scene
    root = tmp_path / "lsbench"
    for sub in ("configs", "traffic", "metrics", "limits", "reference"):
        shutil.copytree(harness.HERE / sub, root / sub)
    bench, cfg, mix = tiny_lm()
    cfg.update(name="tiny-moe", reference="tiny_decoder")
    (root / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    (root / "traffic" / "pretrain.json").write_text(json.dumps(mix))
    (root / "reference" / "tiny_decoder.py").write_text(
        "from lsbench.reference.lm_decoder import *  # noqa: F401,F403\n")
    (root / "limits" / "tiny-moe.pretrain.json").write_text(json.dumps(
        {k: {"limit": v} for k, v in LIMITS.items()}))
    bench["configs"].append({"name": "tiny-moe", "source": "test",
                             "file": "lsbench/configs/tiny-moe.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-moe.pretrain",
                               "config": "tiny-moe", "traffic": "pretrain",
                               "chips": 1, "why": "test"})
    lm_train.reporting(bench, "tiny-moe.pretrain")
    monkeypatch.setattr(harness, "HERE", root)
    monkeypatch.setattr(check, "LIMITS", root / "limits")
    res = harness.run_cell(bench, "tiny-moe.pretrain", 2 ** 31 + 5, 0.5,
                           False, "cpu", 0.0)
    assert res["correct"], res["checks"]
    assert list(res["metrics"]) == ["tokens_per_s", "setup_s"]
    assert res["metrics"]["tokens_per_s"]["value"] > 0
    assert set(res["checks"]) == set(LIMITS)
    _, scene_cfg, walk = tiny_scene("tandt-train.walk")
    res = harness.run_cell(bench, "tandt-train.walk", 4, 0.5, False, "cpu",
                           0.0, cfg=scene_cfg, traffic=walk)
    assert list(res["metrics"]) == ["frames_per_s", "frame_ms_p95",
                                    "setup_s"]


TRAIN_CELL = "minicpm3-4b.train4k"
TRAIN_METRICS = ("tokens_per_s", "step_mfu.train",
                 "device_idle_share.train")


def _tiny_train_cell():
    """The committed training cell's names, files and limits, with the
    configuration's ``-smoke`` arch and short sequences (a CPU's size)."""
    from lsbench.tests.lm_tiny import tiny_lm
    bench = harness.benchmark()
    _, cfg, _ = tiny_lm("minicpm3-4b")
    cfg["reference"] = harness.config("minicpm3-4b")["reference"]
    mix = dict(harness.mix(harness.workload(bench, TRAIN_CELL)["traffic"]),
               seq_len=48)
    return bench, cfg, mix


def test_the_training_cell_reports_its_metrics(monkeypatch):
    """``minicpm3-4b.train4k``'s lines carry ``tokens_per_s`` and
    ``setup_s``, and traced, the two readers' metrics (the CPU has no
    device operations, so the slice's busy time stands in for them)."""
    from lsbench import devtrace
    bench, cfg, mix = _tiny_train_cell()
    res = harness.run_cell(bench, TRAIN_CELL, 2 ** 31 + 9, 0.3, False,
                           "cpu", 0.0, cfg=cfg, traffic=mix)
    assert res["correct"], res["checks"]
    assert list(res["metrics"]) == ["tokens_per_s", "setup_s"]
    assert set(res["checks"]) == set(check.load_limits(TRAIN_CELL))
    real = devtrace.profiled

    def busy(fn):
        out, sl = real(fn)
        return out, sl._replace(busy_s=sl.wall_s / 4)

    monkeypatch.setattr(devtrace, "profiled", busy)
    res = harness.run_cell(bench, TRAIN_CELL, 2 ** 31 + 9, 0.3, True,
                           "cpu", 0.0, cfg=cfg, traffic=mix)
    assert list(res["metrics"]) == ["step_mfu.train",
                                    "device_idle_share.train"]
    assert 0 < res["metrics"]["device_idle_share.train"]["value"] < 100
    assert 0 < res["metrics"]["step_mfu.train"]["value"] < 100


def test_training_readers_take_the_untraced_steps():
    """Both readers divide by the window's untraced step times, not by
    the traced steps' wall time, which the profiler stretches: 2 traced
    steps busy 6 s in all over untraced steps of 4, 4 and 5 s are idle
    25 %, and 3 steps of 1.2e15 operations in 13 s are 28.0 % of 989
    TFLOP/s."""
    from lsbench import devtrace, peaks
    sl = devtrace.Slice(wall_s=20.0, busy_s=6.0, stage_s={}, op_s={},
                        gaps=[], device_ops=10)
    obs = dict(kind="lm_train", slice=sl, traced_steps=2,
               step_seconds=[4.0, 4.0, 5.0], flops_per_step=1.2e15)
    assert harness.reader("device_idle_share.train")(obs) == 25.0
    assert harness.reader("step_mfu.train")(obs) == pytest.approx(
        3 * 1.2e15 / 13.0 / peaks.BF16_FLOPS_PER_S * 100.0)


def test_no_scene_cell_gains_a_training_metric():
    bench = harness.benchmark()
    e2e = [m["name"] for m in bench["end_to_end"]]
    for w in bench["workloads"]:
        if w["name"] == TRAIN_CELL:
            continue
        reported = [m["name"] for m in bench["end_to_end"]
                    if harness.applies(m, w["name"], e2e)]
        reported += [m["name"] for m in bench["per_layer"]
                     if harness.applies(m, w["name"], reported)]
        assert not set(reported) & set(TRAIN_METRICS), w["name"]


def test_training_readers_read_nothing_without_the_device():
    """On a traced CPU run the trace holds no device operation: the
    readers return nothing rather than a share of the card's peak."""
    bench, cfg, mix = _tiny_train_cell()
    res = harness.run_cell(bench, TRAIN_CELL, 2 ** 31 + 9, 0.3, True,
                           "cpu", 0.0, cfg=cfg, traffic=mix)
    assert res["correct"] and res["metrics"] == {}
    for name in TRAIN_METRICS[1:]:
        assert harness.reader(name)({"kind": "stream"}) is None
