"""``optimizer_ms.train``: the device ms a traced training step spends
under the program's ``repro.train/optimizer`` range (``train_step``'s
AdamW: the clip norm and the update); nothing where the program has no
such range, and nothing in a cell that trains nothing."""
import pytest

from lsbench import devtrace, harness

METRIC = "optimizer_ms.train"
TRAIN_CELL = "minicpm3-4b.train4k"


def _obs(stage_s):
    sl = devtrace.Slice(wall_s=3.0, busy_s=2.5, stage_s=stage_s, op_s={},
                        gaps=[], device_ops=10)
    return dict(kind="lm_train", slice=sl, traced_steps=2,
                step_seconds=[1.3, 1.3], flops_per_step=1e15)


def test_optimizer_reader_takes_the_optimizer_span():
    read = harness.reader(METRIC)
    assert read(_obs({"repro.train/step": 0.4,
                      "repro.train/optimizer": 0.07})) == pytest.approx(35.0)


@pytest.mark.parametrize("obs", [
    _obs({"repro.train/step": 0.4}),
    _obs({"repro.train/step": 0.4, "repro.train/optimizer": 0.0}),
    {"kind": "lm_train"},
    {"kind": "stream"},
], ids=["no_span", "empty_span", "untraced", "scene"])
def test_optimizer_reader_reads_nothing_without_the_span(obs):
    """A program without the range (the one before it was added), a
    scene cell and an untraced run give no number, and do not raise."""
    assert harness.reader(METRIC)(obs) is None


def test_optimizer_metric_is_the_training_cells_alone():
    bench = harness.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert entry["moves"] == "tokens_per_s"
    assert entry["workloads"] == [TRAIN_CELL]
    e2e = [m["name"] for m in bench["end_to_end"]]
    for w in bench["workloads"]:
        reported = [m["name"] for m in bench["end_to_end"]
                    if harness.applies(m, w["name"], e2e)]
        assert harness.applies(entry, w["name"], reported) == (
            w["name"] == TRAIN_CELL), w["name"]
