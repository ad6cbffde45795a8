"""One run of one cell: find its files by name, drive the program, check
what it produced against the reference, and build the result line.

``BENCHMARK.json`` names each cell's configuration and traffic mix;
``configs/<config>.json`` and ``traffic/<traffic>.json`` hold them, the
mix's ``kind`` names the driver module (``stream``: one closed-loop
viewer; ``venue``: open-loop viewers served by ``StreamServer``;
``lm_train``: the port's train step), and each per-layer metric is read
by ``metrics/<name>.py``'s ``read(obs)``. A driver module that defines
``numbers(cell, out)`` gives its own check's numbers; the others' frames
are held against ``reference/render.py``. A new cell, configuration,
mix, metric or driver is a new file and an entry.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from lsbench import check

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float     # host clock when the process started
    marks: List[tuple] = dataclasses.field(default_factory=list)

    def mark(self, what: str) -> None:
        """Note the end of a set-up phase (printed by ``lsbench.run``)."""
        self.marks.append((what, time.perf_counter()))

    def setup_phases(self) -> str:
        t, parts = self.t_process, []
        for what, at in self.marks:
            parts.append(f"{what} {at - t:.3f} s")
            t = at
        return ", ".join(parts)

    def memory_peak(self) -> int:
        if torch.device(self.device).type == "cuda":
            return int(torch.cuda.max_memory_allocated())
        return 0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def load(sub: str, name: str):
    """The module ``<sub>/<name>.py`` under the benchmark's folder."""
    spec = importlib.util.spec_from_file_location(
        f"lsbench.{sub}." + name.replace(".", "_").replace("-", "_"),
        HERE / sub / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py``."""
    return load("metrics", name).read


def applies(metric: dict, cell: str, reported: List[str]) -> bool:
    """Is ``metric`` reported in ``cell``? Listed cells, else every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _group(frames) -> List[List[dict]]:
    windows: "OrderedDict[int, List[dict]]" = OrderedDict()
    for w, kept, _ in frames:
        windows.setdefault(w, []).append(kept)
    return list(windows.values())


def make_cell(bench: dict, name: str, seed: int, seconds: float,
              trace: bool, device: str, t_process: float, *,
              cfg: Optional[dict] = None,
              traffic: Optional[dict] = None) -> Cell:
    entry = workload(bench, name)
    cell = Cell(name, cfg or config(entry["config"]),
                traffic or mix(entry["traffic"]), int(seed), float(seconds),
                bool(trace), device, t_process)
    cell.mark("start and imports")
    return cell


def kind(cell: Cell):
    """The driver module of the cell's traffic mix."""
    return importlib.import_module(f"lsbench.{cell.mix['kind']}")


def drive(cell: Cell) -> dict:
    """Set up, measure and (with ``trace``) trace the cell; the program's
    state is gone when this returns, what the check reads kept."""
    out = kind(cell).run(cell)
    out.pop("venue", None)
    if "scene" in out:
        out["scene"] = tuple(out["scene"])
    return out


def numbers(cell: Cell, out: dict) -> Dict[str, float]:
    """The check's numbers: the driver's own ``numbers(cell, out)`` where
    it has one; else every checked window (and, traced, the slice's
    windows, whose work the reference also counts) against the
    reference."""
    own = getattr(kind(cell), "numbers", None)
    if own is not None:
        return own(cell, out)
    obs, scene = out["obs"], out["scene"]
    parts = [check.compare(cell.config, win, check.reference_window(
        scene, cell.config, win)) for win in out["checked"]]
    if cell.trace and "slice_frames" in obs:
        ref_frames = []
        for win in _group(obs["slice_frames"]):
            frames = check.reference_window(scene, cell.config, win)
            parts.append(check.compare(cell.config, win, frames))
            ref_frames += frames
        n = int(cell.config["num_gaussians"])
        obs["work"] = check.work(ref_frames, n,
                                 min(cell.config["render"]["capacity"], n))
        obs["frame_seconds"] = sum(sec for _, _, sec in obs["slice_frames"])
    return check.merge(parts)


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, *, cfg: Optional[dict] = None,
             traffic: Optional[dict] = None,
             limits: Optional[Dict[str, float]] = None) -> dict:
    """Run ``name`` once; returns the result line (a dict: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, traced
    ``breakdown``, ``checks`` last). ``cfg``, ``traffic`` and ``limits``
    replace the cell's files (tests and probes)."""
    cell = make_cell(bench, name, seed, seconds, trace, device, t_process,
                     cfg=cfg, traffic=traffic)
    out = drive(cell)
    ok, rows = check.judge(numbers(cell, out), check.load_limits(name)
                           if limits is None else limits)
    e2e = [m["name"] for m in bench["end_to_end"]
           if applies(m, name, list(out["e2e"]))]
    metrics = {}
    if not trace:
        for m in bench["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in bench["per_layer"]:
            if applies(m, name, e2e):
                value = reader(m["name"])(out["obs"])
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = torch.device(device)
    on_gpu = dev.type == "cuda"
    result = {
        "correct": ok,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_gpu else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_gpu else "cpu",
            "count": int(workload(bench, name).get("chips", 1)),
            "memory_peak_bytes": int(out["memory_peak_bytes"])},
    }
    if trace and "busy_s" in out:
        result["device"].update(busy_s=out["busy_s"],
                                window_s=out["window_s"])
        result["breakdown"] = out["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    print(f"set-up: {cell.setup_phases()}", file=sys.stderr)
    return result
