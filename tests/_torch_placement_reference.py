"""The reference's side of ``tests/test_torch_placement.py``, run in a
process of its own under ``XLA_FLAGS=--xla_force_host_platform_device_
count=8`` (the flag must precede JAX's start).

First makes the inputs both sides share (``_torch_placement_inputs.
SCENES`` from the reference's generators, and the B streams' dolly
poses) and writes them to the npz at ``argv[1]`` (renamed into place
when complete); then writes one npz (the path in ``argv[2]``):
  - ``stream_mesh``: its device count for 1-12 slots over 1-8 devices;
  - ``single/*`` and ``multi/*``: ``build_render_fn(cam, cfg,
    stream_mesh(8))`` on 8 devices at B = 8, F = 4, as the reference's
    ``test_sharded_streams_match_single_device`` and
    ``test_sharded_multi_scene_matches_single_device`` run it (frames,
    every record field, frame_active and the carries' fields);
  - ``server/*``: a ``StreamServer`` over 4 of the devices on
    ``_torch_placement_inputs.SERVE_TRACE``: its report's JSON, every
    batcher build's (B, slot sids, slot_scene) and each session's
    (sid, phase, scene, frames rendered) and frames.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import engine
from repro.core.camera import look_at, make_camera
from repro.core.gaussians import GaussianScene
from repro.core.pipeline import RenderConfig
from repro.scenes.synthetic import structured_scene
from repro.scenes.trajectory import dolly_trajectory
from repro import serve
from repro.serve import placement
from repro.serve import server as S

import _torch_placement_inputs as I


def _streams(out, prefix, result):
    out[f"{prefix}/frames"] = np.asarray(result.frames)
    out[f"{prefix}/frame_active"] = np.asarray(result.frame_active)
    for name, v in result.records.stacked._asdict().items():
        if v is not None:
            out[f"{prefix}/rec/{name}"] = np.asarray(v)
    out[f"{prefix}/carry/prev_pose"] = np.asarray(result.carries.prev_pose)
    out[f"{prefix}/carry/step"] = np.asarray(result.carries.step)
    for name, v in result.carries.state._asdict().items():
        if v is not None:
            out[f"{prefix}/carry/state/{name}"] = np.asarray(v)


def _make_inputs(path):
    out = {"poses": np.stack([np.asarray(dolly_trajectory(
        I.F, start=(0.03 * i, -0.3, -2.0), target=(0.0, 0.0, 6.0)))
        for i in range(I.B)])}
    for name, (key, n, clutter) in I.SCENES.items():
        scene = structured_scene(jax.random.PRNGKey(key), n, clutter=clutter)
        for field, v in zip(I.FIELDS, scene):
            out[f"{name}/{field}"] = np.asarray(v)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **out)
    os.replace(path + ".tmp", path)
    return out


def _scene(inputs, name):
    return GaussianScene(*(jnp.asarray(inputs[f"{name}/{f}"])
                           for f in I.FIELDS))


def _render(out, inputs):
    cam = make_camera(look_at(*I.CAM_LOOK), width=I.SIZE, height=I.SIZE)
    cfg = RenderConfig(impl="jnp_chunked", **I.STREAM_CFG)
    poses = jnp.asarray(inputs["poses"])
    counts = jnp.asarray(I.COUNTS, jnp.int32)
    phases = engine.stream_phases(I.B, cfg.window)
    carries = engine.init_stream_carries(cam, poses)
    mesh = serve.stream_mesh(I.B)
    assert mesh is not None and mesh.size == I.B, mesh
    _streams(out, "single", serve.build_render_fn(cam, cfg, mesh)(
        _scene(inputs, "single"), poses, counts, phases, carries))
    reg = serve.SceneRegistry(I.MULTI_BUCKETS)
    ids = [reg.register(_scene(inputs, f"multi{i}")).scene_id
           for i in range(4)]
    _streams(out, "multi", serve.build_render_fn(
        cam, cfg, mesh, multi_scene=True)(
            reg.stack(ids, I.B), poses, counts, phases, carries,
            jnp.asarray(I.SLOT_SCENE, jnp.int32)))


def _meshes(out):
    devices = jax.devices()
    out["stream_mesh"] = np.asarray(json.dumps({
        f"{s}|{n}": None if (m := placement.stream_mesh(s, devices[:n]))
        is None else int(m.size) for n in range(1, 9) for s in range(1, 13)}))


def _serve(out, inputs):
    devices = jax.devices()[:I.SERVE_DEVICES]
    S.stream_mesh = lambda b, devices=devices: placement.stream_mesh(
        b, devices)
    builds = []
    build = serve.ContinuousBatcher.build

    def recording_build(self, manager):
        batch = build(self, manager)
        builds.append([self.slots, list(batch.sids),
                       np.asarray(batch.slot_scene).tolist()])
        return batch

    serve.ContinuousBatcher.build = recording_build
    cam = make_camera(look_at(*I.CAM_LOOK), width=I.SIZE, height=I.SIZE)
    reg = serve.SceneRegistry(I.SERVE_SCFG["scene_buckets"])
    reg.register(_scene(inputs, "multi0"))
    reg.register(_scene(inputs, "multi1"))
    srv = serve.StreamServer(reg, cam,
                             RenderConfig(impl="jnp_chunked", **I.SERVE_CFG),
                             serve.ServeConfig(**I.SERVE_SCFG))
    sessions = []
    attach = srv.try_attach

    def recording_attach(*a, **k):
        sess = attach(*a, **k)
        sessions.append(sess)
        return sess

    srv.try_attach = recording_attach
    report = srv.run(serve.ReplayTraffic(
        I.SERVE_TRACE, serve.TrafficConfig(**I.SERVE_TRAFFIC)),
        max_rounds=60)
    out["server/report"] = np.asarray(json.dumps(
        {k: report[k] for k in ("rounds_trace", "num_devices",
                                "slots_history", "streams_finished")}))
    out["server/builds"] = np.asarray(json.dumps(builds))
    out["server/sessions"] = np.asarray(json.dumps(
        [[s.sid, s.phase, s.scene_id, s.frames_rendered] for s in sessions]))
    for s in sessions:
        out[f"server/frames/{s.sid}"] = np.concatenate(
            [np.asarray(f) for f in s.frames])


def main():
    out = {}
    inputs = _make_inputs(sys.argv[1])
    _meshes(out)
    _render(out, inputs)
    _serve(out, inputs)
    np.savez(sys.argv[2], **out)
    print(json.dumps({"devices": jax.device_count(), "keys": len(out)}))


if __name__ == "__main__":
    main()
