"""``BENCHMARK.json`` within the form its readers hold it to: keys, names,
lengths, bounds, and which cells report which metric."""
import re

from lsbench import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def test_entries_have_their_keys_names_and_lengths():
    bench = harness.benchmark()
    assert set(bench) == TOP
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(word) for word in bench["command"])
    assert 1 <= int(bench["run_seconds"]) <= 51
    for group, keys in KEYS.items():
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names)), group
        for e in bench[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(e) <= keys | extra, e["name"]
            assert NAME.fullmatch(e["name"]), e["name"]
            for key in ("why", "layer"):
                if key in e:
                    assert _line(e[key]), e["name"]
    for c in bench["configs"]:
        assert _line(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25, m["name"]


def test_every_list_of_cells_names_cells_and_every_cell_reports():
    """A ``workloads`` list is never empty and names only cells; each cell
    reports ``setup_s``, another end-to-end metric and a per-layer one,
    and a per-layer metric's cells report the metric it moves."""
    bench = harness.benchmark()
    cells = [w["name"] for w in bench["workloads"]]
    configs = {c["name"] for c in bench["configs"]}
    assert {w["config"] for w in bench["workloads"]} == configs
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            assert m["workloads"], m["name"]
            assert set(m["workloads"]) <= set(cells), m["name"]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for cell in cells:
        reported = [m["name"] for m in bench["end_to_end"]
                    if harness.applies(m, cell, list(e2e))]
        assert "setup_s" in reported and len(reported) >= 2, cell
        layers = [m for m in bench["per_layer"]
                  if harness.applies(m, cell, reported)]
        assert layers, cell
        assert all(m["moves"] in reported for m in layers), cell


def test_every_name_has_its_files():
    """Each configuration's file and plain reference, each cell's mix and
    limits, and each per-layer metric's reader are where the harness
    looks for them by name."""
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert (harness.REPO / c["file"]).is_file(), c["name"]
        ref = harness.config(c["name"]).get("reference")
        if ref is not None:
            assert (harness.HERE / "reference" / f"{ref}.py").is_file()
    for w in bench["workloads"]:
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (harness.HERE / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert callable(harness.reader(m["name"])), m["name"]
