"""Streaming serving subsystem (port of ``repro/serve``).

A scene registry pads scenes to bucketed Gaussian counts so same-bucket
scenes share cache entries (``scenes``); sessions attach and detach with
phase-staggered key-frame schedules (``session``); a scene-aware
continuous batcher packs streams into an elastic B-slot batch over
``engine.render_streams`` (``batcher``); a bucketed cache bounds the
``(B, R)`` shapes (``cache``); ``placement`` builds the render callable;
an admission controller plans each round's scene-bucket groups with
aging, backpressure and SLO classes (``admission``); and ``server`` ties
them into ragged mixed-bucket serving rounds with latency, throughput,
utilization and fairness metrics plus optional simulated accelerator
latencies.
"""
from repro_torch.serve.admission import (AdmissionConfig,
                                         AdmissionController,
                                         AdmissionRejected, BucketDemand,
                                         DEFAULT_SLO_CLASSES, SLOClass,
                                         jain_index)
from repro_torch.serve.batcher import ContinuousBatcher, SlotBatch
from repro_torch.serve.cache import (BucketPolicy, ExecutableCache,
                                     pick_capacity, snap_capacity,
                                     suggest_buckets, suggest_capacity,
                                     validate_buckets)
from repro_torch.serve.placement import build_render_fn, stream_mesh
from repro_torch.serve.scenes import (SceneEntry, SceneRegistry, pad_scene,
                                      snap_scene_bucket)
from repro_torch.serve.server import (PoissonTraffic, ReplayTraffic,
                                      ServeConfig, StreamServer,
                                      TrafficConfig, burst_trace,
                                      skewed_trace)
from repro_torch.serve.session import SessionManager, StreamSession

__all__ = [
    "AdmissionConfig", "AdmissionController", "AdmissionRejected",
    "BucketDemand", "BucketPolicy", "ContinuousBatcher",
    "DEFAULT_SLO_CLASSES", "ExecutableCache", "PoissonTraffic",
    "ReplayTraffic", "SLOClass", "SceneEntry", "SceneRegistry",
    "ServeConfig", "SessionManager", "SlotBatch", "StreamServer",
    "StreamSession", "TrafficConfig", "build_render_fn", "burst_trace",
    "jain_index", "pad_scene", "pick_capacity", "skewed_trace",
    "snap_capacity", "snap_scene_bucket", "stream_mesh", "suggest_buckets",
    "suggest_capacity", "validate_buckets",
]
