"""A cell, a configuration, a mix and a metric are added by files and
entries alone: nothing of the harness is edited."""
import json
import shutil

from lsbench import check, harness
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
