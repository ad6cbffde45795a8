"""Port parity for the serve layer (``repro_torch.serve``) against the
JAX reference on the CPU.

Host logic (scenes, sessions, cache, admission, batcher, traffic): the
same call sequence through both packages gives the same outputs, exactly.
End to end: one module-scoped run of both ``StreamServer``s on the same
``ReplayTraffic`` at 48x48 with two scenes in one bucket, static B = 2
and ``r_buckets=(4, 8)`` (at most two reference compilations). Rounds,
R picks, admitted sessions, cache keys (less the impl name) and the
report's non-timing fields agree exactly; per-session frames within 1e-4
(the warp chains frames over a trajectory)."""
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import _torch_parity as P
from repro.core.camera import look_at as jlook_at, make_camera as jmake_camera
from repro.core.pipeline import RenderConfig as JRenderConfig
from repro.scenes.synthetic import random_blob_scene, structured_scene
from repro import serve as jserve
from repro_torch import serve as tserve
from repro_torch.core import engine as tengine
from repro_torch.core.pipeline import RenderConfig as TRenderConfig
from repro_torch.obs.trace import validate_chrome_trace

TRAJ_ATOL = 1e-4
CPU = "cpu"
TRACE = [[0, 1, 1], [1], [], [0, 0], [1]]
TRAFFIC = dict(min_frames=3, max_frames=6, seed=3, scenes=2)


def _scenes():
    return [structured_scene(jax.random.PRNGKey(100), 260, clutter=0.3),
            random_blob_scene(jax.random.PRNGKey(101), 200, sh_degree=1)]


# --- scenes ----------------------------------------------------------------

def test_snap_and_pad_scene_match_reference():
    for n in (3, 256, 257, 512):
        assert tserve.snap_scene_bucket(n, (256, 512)) == \
            jserve.snap_scene_bucket(n, (256, 512))
    for n, buckets in ((513, (256, 512)), (10, (512, 256))):
        with pytest.raises(ValueError):
            tserve.snap_scene_bucket(n, buckets)
    jscene = _scenes()[1]
    got = tserve.pad_scene(P.scene(jscene), 512, device=CPU)
    want = jserve.pad_scene(jscene, 512)
    for g, w in zip(got, want):
        P.assert_equal(g, w)
    assert tserve.scenes.PAD_OPACITY_LOGIT == \
        jserve.scenes.PAD_OPACITY_LOGIT


def test_registry_sequence_matches_reference():
    jreg, treg = jserve.SceneRegistry((256, 512)), \
        tserve.SceneRegistry((256, 512), device=CPU)
    blob = random_blob_scene(jax.random.PRNGKey(2), 100)
    for s in _scenes()[:1] + [blob]:
        je, te = jreg.register(s), treg.register(P.scene(s))
        assert (te.scene_id, te.bucket, te.true_n, te.padded_bytes) == \
            (je.scene_id, je.bucket, je.true_n, je.padded_bytes)
    for reg in (jreg, treg):
        reg.acquire(0)
        with pytest.raises(ValueError):
            reg.evict(0)
        reg.acquire(0)
        reg.release(0)
        with pytest.raises(ValueError):
            reg.release(1)
        with pytest.raises(ValueError):
            reg.stack([0, 1], 4)            # bucket mismatch
    assert treg.stats() == jreg.stats()
    assert treg.by_bucket((512, 4)) == jreg.by_bucket((512, 4))
    stack = treg.stack([0], 3)
    assert len(stack) == 3 and all(s is stack[0] for s in stack)
    jreg.release(0)
    treg.release(0)
    assert treg.evict(0).scene_id == jreg.evict(0).scene_id == 0
    assert treg.stats() == jreg.stats()


# --- sessions and batcher --------------------------------------------------

def test_session_manager_sequence_matches_reference():
    eye = np.eye(4, dtype=np.float32)
    ms = jserve.SessionManager(window=4), tserve.SessionManager(window=4)
    out = []
    for m in ms:
        got = [m.attach(np.stack([eye] * (1 + i % 3)), now=float(i),
                        scene_id=i % 2).phase for i in range(6)]
        m.detach(2)
        got.append(m.attach(closed=False).phase)
        with pytest.raises(ValueError):
            m.attach(closed=True)
        got += [[s.sid for s in m.waiting()],
                [s.sid for s in m.by_scene(1)], list(m._phase_load), len(m)]
        out.append(got)
    assert out[0] == out[1]


def test_batcher_sequence_matches_reference(small_cam):
    """Admission, scene packing in groups of 2, build and a resize
    through both batchers give the same slots, counts and scene maps."""
    eye = np.eye(4, dtype=np.float32)
    tcam = P.camera(small_cam)
    runs = []
    for serve, cam in ((jserve, small_cam), (tserve, tcam)):
        m = serve.SessionManager(window=4)
        bat = serve.ContinuousBatcher(slots=4, chunk=3, cam=cam, group=2)
        for i, sc in enumerate((10, 20, 10, 20, 10)):
            m.attach(np.stack([eye] * (2 + i)), now=float(i), scene_id=sc)
        trace = [bat.admit(m, allowed={10, 20})]
        batch = bat.build(m)
        trace += [batch.sids, np.asarray(batch.counts).tolist(),
                  np.asarray(batch.phases).tolist(), batch.scene_ids,
                  np.asarray(batch.slot_scene).tolist(),
                  batch.active_frames, batch.enq_times]
        trace += [bat.resize(2, m), bat.admit(m), bat.build(m).sids,
                  bat.empty_batch(slots=3).sids]
        runs.append(trace)
    assert runs[0] == runs[1]


def test_batcher_commit_threads_carries(small_cam):
    """A fake result echoing the batch's carries: drained sessions
    detach, latencies are stamped, carries come back per session."""
    eye = np.eye(4, dtype=np.float32)
    m = tserve.SessionManager(window=4)
    bat = tserve.ContinuousBatcher(slots=2, chunk=3, cam=P.camera(small_cam))
    s0 = m.attach(np.stack([eye] * 2), now=0.0)
    s1 = m.attach(np.stack([eye] * 4), now=0.0)
    bat.admit(m)
    batch = bat.build(m)
    fake = SimpleNamespace(carries=batch.carries)
    assert [s.sid for s in bat.commit(batch, fake, m, now=1.5)] == [s0.sid]
    assert list(s0.latencies) == [1.5, 1.5] and s1.frames_rendered == 3
    assert s1.carry.step == 0 and tuple(s1.carry.prev_pose.shape) == (4, 4)


# --- cache, policy and admission -------------------------------------------

def test_cache_and_policy_match_reference():
    active = np.zeros((8, 16), bool)
    active[:, :2] = True
    overflow = np.full((8,), 8)
    overflow[7] = 0
    is_full = np.zeros((8,), bool)
    is_full[0] = True
    mask = np.arange(8) < 7
    recs = SimpleNamespace(active=active, overflow_tiles=overflow,
                           is_full=is_full)
    trecs = SimpleNamespace(**{k: torch.from_numpy(v)
                               for k, v in vars(recs).items()})
    for q, buckets, fm in ((0.9, (4, 16, 32), mask), (0.5, (4, 8), None)):
        assert tserve.suggest_capacity(trecs, q, buckets, frame_mask=fm) == \
            jserve.suggest_capacity(recs, q, buckets, frame_mask=fm)
    for d in (0, 3, 8, 9, 999):
        assert tserve.snap_capacity(d, (8, 16, 32)) == \
            jserve.snap_capacity(d, (8, 16, 32))
    jp = jserve.BucketPolicy(b_buckets=(2, 4, 8), r_buckets=(4, 16))
    tp = tserve.BucketPolicy(b_buckets=(2, 4, 8), r_buckets=(4, 16))
    assert tp.max_keys == jp.max_keys
    for depth, demands in ((0, []), (3, [3, 3, 20]), (100, [2, 2])):
        assert tp.pick(depth, demands) == jp.pick(depth, demands)
    assert tserve.suggest_buckets(trecs, 3, tp) == \
        jserve.suggest_buckets(recs, 3, jp)
    stats = []
    for cache in (jserve.ExecutableCache(), tserve.ExecutableCache()):
        fa = cache.get(("b", 8), lambda: (lambda: "a"))
        assert cache.get(("b", 8)) is fa
        fa()
        cache.get(("c", 16), lambda: (lambda: "b"))
        cache.evict_keys(lambda k: k[0] == "c")
        st = cache.stats()
        st.pop("per_key_timing")
        stats.append((st, list(cache.log)))
    assert stats[0] == stats[1]


_ADMISSION_CFGS = {
    "mixed_cap1": dict(max_groups_per_round=1, max_wait_rounds=2),
    "mixed": dict(),
    "drain": dict(mode="drain"),
    "backpressure": dict(max_waiting=2),
}


@pytest.mark.parametrize("name", sorted(_ADMISSION_CFGS))
def test_admission_sequence_matches_reference(name):
    """Eight rounds of skewed demand with SLO classes: round plans,
    wait clocks, offers and the fairness report agree exactly."""
    kw = _ADMISSION_CFGS[name]
    rng = np.random.default_rng(7)
    rounds = []
    for r in range(8):
        rounds.append({b: dict(depth=int(rng.integers(0, 5)),
                               pending=int(rng.integers(0, 3)),
                               bound=int(rng.integers(0, 2)),
                               weight=float(rng.choice([0.25, 1.0, 4.0])),
                               wait_bound=None if r % 3 else 1,
                               order=float(rng.integers(0, 20)))
                       for b in ("a", "b", "c")})
    out = []
    for serve in (jserve, tserve):
        adm = serve.AdmissionController(serve.AdmissionConfig(**kw))
        log = []
        for r, demand in enumerate(rounds):
            d = {b: serve.BucketDemand(weighted_depth=float(v["depth"]), **v)
                 for b, v in demand.items()}
            plan = adm.plan_round(d)
            adm.note_round(d, plan[:1] if r % 2 else plan)
            for b in plan:
                adm.record_service(b, 2)
            log.append((plan, [adm.wait_of(b) for b in "abc"],
                        adm.offer(r % 4)))
        out.append((log, adm.report(), adm.metrics.snapshot()))
    assert out[0] == out[1]
    assert tserve.jain_index([1.0, 0.5, 0.0]) == \
        jserve.jain_index([1.0, 0.5, 0.0])


def test_traffic_matches_reference():
    assert tserve.skewed_trace(23, skew=4) == jserve.skewed_trace(23, skew=4)
    assert tserve.burst_trace(9, burst_every=2, burst_size=4) == \
        jserve.burst_trace(9, burst_every=2, burst_size=4)
    cfg = dict(n_streams=7, rate=2.5, min_frames=2, max_frames=9, seed=5,
               scenes=3)
    jt = jserve.PoissonTraffic(jserve.TrafficConfig(**cfg))
    tt = tserve.PoissonTraffic(tserve.TrafficConfig(**cfg))
    while not jt.done:
        ja, ta = jt.arrivals(), tt.arrivals()
        assert [i for _, i in ta] == [i for _, i in ja]
        for (tp, _), (jp, _) in zip(ta, ja):
            np.testing.assert_allclose(tp, np.asarray(jp), atol=1e-6)
    assert tt.done and tt.arrived == jt.arrived


def test_placement_degrades_to_render_streams():
    assert tserve.stream_mesh(4) is None          # no CUDA device here
    assert tserve.stream_mesh(4, devices=[CPU]) is None
    mesh = tserve.stream_mesh(6, devices=["cuda:0", "cuda:1", "cuda:2",
                                          "cuda:3"])
    assert len(mesh) == 3
    assert callable(tserve.build_render_fn(None, None, multi_scene=True))


# --- end to end: both servers on one replayed trace ------------------------

def _serve(serve, reg, cam, cfg, scfg, **kw):
    srv = serve.StreamServer(reg, cam, cfg, scfg, **kw)
    sessions = []
    attach = srv.try_attach

    def recording_attach(*a, **k):
        sess = attach(*a, **k)
        sessions.append(sess)
        return sess

    srv.try_attach = recording_attach
    report = srv.run(serve.ReplayTraffic(TRACE, serve.TrafficConfig(
        **TRAFFIC)), max_rounds=60)
    return srv, sessions, report


@pytest.fixture(scope="module")
def served():
    jcam = jmake_camera(jlook_at((0.0, -0.3, -2.0), (0.0, 0.0, 6.0)),
                        width=48, height=48)
    base = dict(capacity=128, chunk=32, window=4)
    scfg = dict(slots=2, chunk=2, r_buckets=(4, 8), adapt_every=2,
                scene_buckets=(512,), collect_frames=True, sim_latency=True,
                trace=True)
    jreg, treg = jserve.SceneRegistry((512,)), \
        tserve.SceneRegistry((512,), device=CPU)
    for s in _scenes():
        jreg.register(s)
        treg.register(P.scene(s))
    want = _serve(jserve, jreg, jcam, JRenderConfig(impl="jnp_chunked",
                                                   **base),
                  jserve.ServeConfig(**scfg))
    got = _serve(tserve, treg, P.camera(jcam),
                 TRenderConfig(impl="cuda", **base),
                 tserve.ServeConfig(**scfg), device=CPU)
    return got, want


def _round_view(info):
    return {k: v for k, v in info.items() if k != "render_seconds"}


def test_serve_rounds_match_reference(served):
    (tsrv, _, trep), (jsrv, _, jrep) = served
    assert trep["streams_finished"] == jrep["streams_finished"] == 7
    assert [_round_view(r) for r in trep["rounds_trace"]] == \
        [_round_view(r) for r in jrep["rounds_trace"]]
    assert trep["capacity_history"] == jrep["capacity_history"]
    assert trep["slots_history"] == jrep["slots_history"]
    tkeys = {tuple(k[:-1]) for k in trep["cache"]["keys"]}
    jkeys = {tuple(k[:-1]) for k in jrep["cache"]["keys"]}
    assert tkeys == jkeys and len(tkeys) <= 2
    assert {k[-1] for k in trep["cache"]["keys"]} == {"cuda"}
    for key in ("streams_served", "max_concurrent", "frames", "rounds",
                "busy_rounds", "slot_utilization", "capacity", "slots",
                "scenes", "fairness", "sim", "num_devices",
                "rounds_trace_dropped"):
        assert trep[key] == jrep[key], key
    for b, stats in trep["per_bucket"].items():
        want = jrep["per_bucket"][b]
        for key in ("frames", "max_wait_rounds", "demand_rounds",
                    "served_rounds", "share", "slots"):
            assert stats[key] == want[key], (b, key)
    assert trep["cache"]["hits"] == jrep["cache"]["hits"]
    assert trep["cache"]["misses"] == jrep["cache"]["misses"]


def test_serve_session_frames_match_reference(served):
    (_, tsess, _), (_, jsess, _) = served
    assert len(tsess) == len(jsess) == 7
    for t, j in zip(tsess, jsess):
        assert (t.sid, t.phase, t.scene_id, t.frames_rendered) == \
            (j.sid, j.phase, j.scene_id, j.frames_rendered)
        P.assert_close(torch.cat(t.frames), np.concatenate(j.frames),
                       atol=TRAJ_ATOL)


def test_serve_session_equals_solo_render(small_cam):
    """Port against port, with one R bucket so that a solo run exists:
    each served session's frames equal a solo ``render_trajectory`` of
    its poses at its phase, bit for bit, across chunk seams."""
    cfg = TRenderConfig(impl="cuda", capacity=128, chunk=32, window=3,
                        rerender_capacity=8)
    reg = tserve.SceneRegistry((512,), device=CPU)
    scenes = [reg.register(P.scene(s)).scene_id for s in _scenes()]
    srv = tserve.StreamServer(reg, P.camera(small_cam), cfg,
                              tserve.ServeConfig(slots=2, chunk=2,
                                                 r_buckets=(8,),
                                                 scene_buckets=(512,),
                                                 collect_frames=True),
                              device=CPU)
    poses = [tserve.server.sample_trajectory(
        np.random.default_rng(i), tserve.TrafficConfig(min_frames=5,
                                                       max_frames=5))
        for i in range(3)]
    sessions = [srv.attach(p, scene_id=scenes[i % 2])
                for i, p in enumerate(poses)]
    assert srv.run(max_rounds=20)["streams_finished"] == 3
    for sess, p in zip(sessions, poses):
        solo = tengine.render_trajectory(
            reg.get(sess.scene_id).scene, srv.cam, torch.from_numpy(p), cfg,
            phase=sess.phase)
        assert torch.equal(torch.cat(sess.frames), solo.frames)


def test_warmup_builds_every_key(small_cam):
    """``warmup`` creates one cache entry per (scene bucket, B, R) on
    all-masked batches, and the served run that follows only hits them."""
    cfg = TRenderConfig(impl="cuda", capacity=128, chunk=32, window=3)
    reg = tserve.SceneRegistry((512,), device=CPU)
    scenes = [reg.register(P.scene(s)).scene_id for s in _scenes()]
    srv = tserve.StreamServer(reg, P.camera(small_cam), cfg,
                              tserve.ServeConfig(chunk=2, b_buckets=(2, 4),
                                                 r_buckets=(4, 8),
                                                 scene_buckets=(512,)),
                              device=CPU)
    srv.warmup()
    keys = {tuple(k) for k in srv.cache.stats()["keys"]}
    bucket = str(reg.bucket_of(scenes[0]))
    assert keys == {(bucket, str(b), "2", str(r), "3", "cuda")
                    for b in (2, 4) for r in (4, 8)}
    misses = srv.cache.stats()["misses"]
    srv.attach(tserve.server.sample_trajectory(
        np.random.default_rng(0), tserve.TrafficConfig(min_frames=3,
                                                       max_frames=3)),
        scene_id=scenes[1])
    assert srv.run(max_rounds=10)["streams_finished"] == 1
    assert srv.cache.stats()["misses"] == misses


def test_serve_trace_validates(served):
    (tsrv, _, trep), _ = served
    summary = validate_chrome_trace(tsrv.tracer.to_chrome())
    assert {"round", "dispatch", "barrier", "commit", "compile"} <= \
        set(summary["names"])
    assert trep["metrics"]["counters"]["serve_frames_total"] == \
        trep["frames"]
