"""The result line has the contract's keys in its order, and a run with
no card prints none."""
import json

import pytest

from lsbench.tests.tiny import run_tiny


def test_result_keys_and_order():
    res = run_tiny("tandt-train.walk")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95",
                                   "setup_s"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(res)


def test_traced_result_has_breakdown_before_checks():
    res = run_tiny("tandt-train.walk", trace=True)
    assert list(res)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "frames_per_s" not in res["metrics"]
    assert "host_syncs_per_frame.stream" in res["metrics"]
    share = res["metrics"]["rerender_tile_share.stream"]["value"]
    assert 0.0 < share <= 100.0


def test_venue_reports_its_own_metrics():
    res = run_tiny("tandt-train.venue", seconds=1.0)
    assert set(res["metrics"]) == {"frames_per_s", "serve_latency_ms_p95",
                                   "setup_s"}


def test_no_card_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from lsbench import run
    rc = run.main(["--workload", "tandt-train.walk", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""
