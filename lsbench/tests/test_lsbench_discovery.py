"""A cell, a configuration, a mix and a metric are added by files and
entries alone: nothing of the harness is edited."""
import json
import shutil

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
    cfg.update(name="tiny-moe", reference="tiny_gqa")
    (root / "configs" / "tiny-moe.json").write_text(json.dumps(cfg))
    (root / "traffic" / "pretrain.json").write_text(json.dumps(mix))
    shutil.copy(root / "reference" / "lm_gqa.py",
                root / "reference" / "tiny_gqa.py")
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
