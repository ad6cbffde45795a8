"""The port stands alone: no JAX and nothing of ``repro`` in
``repro_torch``, ``chip_smoke.py`` or the family configs it shares with
the tests (``tests/_torch_family_configs.py``), kernel modules import without
nvcc or triton, and entry points left at their default device refuse to
run without a GPU."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_repro_or_toolchain():
    code = (
        "import sys\n"
        f"for m in {_modules()!r}:\n"
        "    __import__(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) +
                         [ROOT / "chip_smoke.py",
                          ROOT / "tests" / "_torch_family_configs.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)


def _cpu_scene():
    from repro_torch.scenes import synthetic
    return synthetic.structured_scene(0, 64, device="cpu")


def _cpu_camera():
    from repro_torch.core import camera
    return camera.make_camera(np.eye(4, dtype=np.float32), width=32,
                              height=32, device="cpu")


def _default_device_calls():
    from repro_torch import interop, serve
    from repro_torch.core import camera, engine, load_balance, plan
    from repro_torch.core.pipeline import RenderConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as lm_serve
    from repro_torch.launch import train as lm_train
    from repro_torch.models import model
    from repro_torch.train import data, optimizer, train_step
    from repro_torch.scenes import synthetic, trajectory
    lm_cfg = get_config("yi-9b").reduced()
    eye4 = np.eye(4, dtype=np.float32)
    poses = torch.eye(4).expand(2, 3, 4, 4)
    return {
        "render_streams": lambda: engine.render_streams(
            _cpu_scene(), camera.make_camera(eye4, width=32, height=32),
            poses, RenderConfig()),
        "init_stream_carries": lambda: engine.init_stream_carries(
            camera.make_camera(eye4, width=32, height=32), poses),
        "stream_phases": lambda: engine.stream_phases(3, 5),
        "SceneRegistry.register": lambda: serve.SceneRegistry(
            (256,)).register(_cpu_scene()),
        "pad_scene": lambda: serve.pad_scene(_cpu_scene(), 256),
        "StreamServer": lambda: serve.StreamServer(
            _cpu_scene(), _cpu_camera(), RenderConfig()),
        "StreamServer(default-device scene)": lambda: serve.StreamServer(
            synthetic.structured_scene(0, 64), _cpu_camera(),
            RenderConfig()),
        "make_camera": lambda: camera.make_camera(eye4, width=32, height=32),
        "look_at": lambda: camera.look_at((0, 0, -1), (0, 0, 1)),
        "structured_scene": lambda: synthetic.structured_scene(0, 64),
        "random_blob_scene": lambda: synthetic.random_blob_scene(0, 64),
        "dolly_trajectory": lambda: trajectory.dolly_trajectory(2),
        "orbit_trajectory": lambda: trajectory.orbit_trajectory(2),
        "scene_from_numpy": lambda: interop.scene_from_numpy(
            np.zeros((2, 3)), np.zeros((2, 3)), np.ones((2, 4)),
            np.zeros(2), np.zeros((2, 1, 3))),
        "camera_from_numpy": lambda: interop.camera_from_numpy(
            eye4, 1.0, 1.0, 16.0, 16.0, 32, 32),
        "frame_state_from_numpy": lambda: interop.frame_state_from_numpy(
            np.zeros((16, 16, 3)), np.zeros((16, 16)), np.zeros((16, 16)),
            np.zeros((16, 16), bool), 0),
        "full_plan": lambda: plan.full_plan(2, 2),
        "morton_rank": lambda: load_balance.morton_rank(2, 2),
        "init_params": lambda: model.init_params(lm_cfg),
        "empty_params": lambda: model.empty_params(lm_cfg),
        "init_cache": lambda: model.init_cache(lm_cfg, 1, 8),
        "serve": lambda: lm_serve.serve(
            lm_cfg, batch_slots=1, max_seq=8, n_requests=1, prompt_len=2,
            max_new=1),
        "lm_params_from_numpy": lambda: interop.lm_params_from_numpy(
            {"layers": []}, lm_cfg),
        "decode_cache_from_numpy": lambda: interop.decode_cache_from_numpy(
            model.init_cache(lm_cfg, 1, 8, device="cpu")),
        "init_train_state": lambda: train_step.init_train_state(lm_cfg),
        "train_state_from_numpy": lambda: interop.train_state_from_numpy(
            {"layers": []}, None, lm_cfg),
        "batch_at": lambda: data.batch_at(data.DataConfig(), 0),
        "stream": lambda: next(data.stream(data.DataConfig())),
        "train_loop": lambda: lm_train.train_loop(
            lm_cfg, data.DataConfig(), optimizer.OptimizerConfig(),
            lm_train.RunConfig(steps=1)),
    }


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_default_device_refuses_cpu_fallback(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        _default_device_calls()[name]()


def test_cpu_is_available_when_asked():
    from repro_torch.core import camera
    cam = camera.make_camera(camera.look_at((0, 0, -1), (0, 0, 1),
                                            device="cpu"),
                             width=32, height=32, device="cpu")
    assert cam.device.type == "cpu" and cam.w2c.dtype == torch.float32


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without a GPU,
    and in a directory that holds nothing else of the repo."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)],
                              cwd=script.parent, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_interop_to_numpy_round_trip():
    from repro_torch import interop
    from repro_torch.core.pipeline import FrameState
    rng = np.random.default_rng(0)
    arrays = (rng.normal(size=(8, 8, 3)), rng.normal(size=(8, 8)),
              rng.normal(size=(8, 8)), rng.uniform(size=(8, 8)) < 0.5, 3)
    state = interop.frame_state_from_numpy(*arrays, device="cpu")
    assert state.source_mask.dtype == torch.bool
    assert state.frame_idx.dtype == torch.int32
    back = interop.to_numpy(state)
    assert isinstance(back, FrameState) and back.contrib is None
    for got, want in zip(back[:4], arrays[:4]):
        np.testing.assert_allclose(got, np.asarray(want, got.dtype))
    cam = interop.camera_from_numpy(np.eye(4), 10.0, 10.0, 8.0, 8.0, 16, 16,
                                    device="cpu")
    assert interop.to_numpy(cam)["width"] == 16


def test_annotate_names_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.obs.trace import annotate
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with annotate("repro.test/stage"):
            torch.ones(4).sum()
    assert any(e.name == "repro.test/stage" for e in prof.events())
