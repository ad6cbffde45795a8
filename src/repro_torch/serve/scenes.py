"""Scene registry: many scenes, bucketed Gaussian counts, shared
executables (port of ``repro/serve/scenes.py``).

Every registered scene is padded up to a fixed ladder of bucket sizes, and
the executable cache keys on the bucket, not the scene. Padding is exact:
padding rows have ``opacity_logit = PAD_OPACITY_LOGIT``, so preprocess
marks them invalid for every pose and a padded scene renders identically
to the original. Entries are refcounted by attached streams, so ``evict``
never pulls a scene out from under a live stream.

Scenes live on the registry's device (``device="cuda"`` by default).
``stack`` returns the round's scenes as a tuple (the engine's
``slot_scene`` indexes it) instead of stacking them into one
``(S, N, ...)`` array as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core.gaussians import GaussianScene
from repro_torch.serve.cache import validate_buckets

# Pow-2 ladder: padding waste is bounded by 2x, and the executable family
# by the handful of bucket sizes a fleet's scenes span.
DEFAULT_SCENE_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384,
                         32768, 65536)

# sigmoid(-20) ~ 2e-9, far below projection.ALPHA_THRESHOLD (1/255):
# padding Gaussians fail the `visible` cull for every pose.
PAD_OPACITY_LOGIT = -20.0


def snap_scene_bucket(n: int, buckets: Sequence[int] = DEFAULT_SCENE_BUCKETS
                      ) -> int:
    """Smallest bucket covering ``n`` Gaussians; a scene beyond the
    largest bucket is an error (scenes are never truncated)."""
    validate_buckets(buckets, "scene_buckets")
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(
        f"scene with {n} Gaussians exceeds the largest scene bucket "
        f"{buckets[-1]}; extend the bucket ladder")


def pad_scene(scene: GaussianScene, n_bucket: int, *,
              device="cuda") -> GaussianScene:
    """The scene on ``device``, padded to ``n_bucket`` rows with inert
    Gaussians (unit quaternion, unit scale, zero SH, opacity logit -20:
    finite through preprocess, invalid for every pose)."""
    dev = resolve_device(device)
    scene = GaussianScene(*(x.to(dev) for x in scene))
    n = scene.num_gaussians
    if n_bucket < n:
        raise ValueError(f"cannot pad {n} Gaussians down to {n_bucket}")
    if n_bucket == n:
        return scene
    p = n_bucket - n

    def pad(x, fill=0.0):
        return torch.cat([x, torch.full((p,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    quats = torch.zeros((p, 4), dtype=scene.quats.dtype, device=dev)
    quats[:, 0] = 1.0
    return GaussianScene(
        means=pad(scene.means), log_scales=pad(scene.log_scales),
        quats=torch.cat([scene.quats, quats]),
        opacity_logits=pad(scene.opacity_logits, PAD_OPACITY_LOGIT),
        sh=pad(scene.sh))


@dataclasses.dataclass
class SceneEntry:
    """One registered scene (already padded to its bucket).

    ``bucket`` is the scene's shape signature ``(padded N, SH
    coefficient count)``: scenes share an executable iff their buckets
    are equal.
    """

    scene_id: int
    scene: GaussianScene        # padded: num_gaussians == bucket[0]
    true_n: int                 # Gaussians before padding
    bucket: Tuple[int, int]     # (padded N, sh K) — what the cache keys on
    registered_at: float = 0.0
    refs: int = 0               # live sessions pinned to this scene
    streams_seen: int = 0       # lifetime attach count (metrics)
    padded_bytes: int = 0       # device bytes of the padded scene arrays


def scene_bytes(scene: GaussianScene) -> int:
    """Total bytes of a scene's tensors."""
    return sum(x.numel() * x.element_size() for x in scene)


class SceneRegistry:
    """Register/evict scenes on one device; group them by bucket."""

    def __init__(self, buckets: Sequence[int] = DEFAULT_SCENE_BUCKETS, *,
                 device="cuda"):
        validate_buckets(buckets, "scene_buckets")
        self.device = resolve_device(device)
        self.buckets = tuple(int(b) for b in buckets)
        self._entries: Dict[int, SceneEntry] = {}
        self._next_id = 0
        self.registered = 0
        self.evicted = 0

    # -- lifecycle ---------------------------------------------------------
    def register(self, scene: GaussianScene, *,
                 now: float = 0.0) -> SceneEntry:
        n_bucket = snap_scene_bucket(scene.num_gaussians, self.buckets)
        padded = pad_scene(scene, n_bucket, device=self.device)
        entry = SceneEntry(scene_id=self._next_id,
                           scene=padded,
                           true_n=scene.num_gaussians,
                           bucket=(n_bucket, int(scene.sh.shape[1])),
                           registered_at=now,
                           padded_bytes=scene_bytes(padded))
        self._next_id += 1
        self._entries[entry.scene_id] = entry
        self.registered += 1
        return entry

    def evict(self, scene_id: int) -> SceneEntry:
        entry = self.get(scene_id)
        if entry.refs > 0:
            raise ValueError(
                f"scene {scene_id} has {entry.refs} attached stream(s); "
                f"drain them before evicting")
        self.evicted += 1
        return self._entries.pop(scene_id)

    def acquire(self, scene_id: int) -> None:
        entry = self.get(scene_id)
        entry.refs += 1
        entry.streams_seen += 1

    def release(self, scene_id: int) -> None:
        entry = self.get(scene_id)
        if entry.refs <= 0:
            raise ValueError(f"scene {scene_id} released more than acquired")
        entry.refs -= 1

    # -- queries -----------------------------------------------------------
    def get(self, scene_id: int) -> SceneEntry:
        if scene_id not in self._entries:
            raise KeyError(f"unknown scene {scene_id!r}; registered: "
                           f"{self.ids()}")
        return self._entries[scene_id]

    def ids(self) -> Tuple[int, ...]:
        """Registration order — what traffic round-robins over."""
        return tuple(self._entries)

    def by_bucket(self, bucket: Tuple[int, int]) -> List[int]:
        return [i for i, e in self._entries.items() if e.bucket == bucket]

    def bucket_of(self, scene_id: int) -> Tuple[int, int]:
        return self.get(scene_id).bucket

    def buckets_in_use(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(sorted({e.bucket for e in self._entries.values()}))

    def __contains__(self, scene_id: int) -> bool:
        return scene_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    # -- device-side view --------------------------------------------------
    def stack(self, scene_ids: Sequence[int],
              size: int) -> Tuple[GaussianScene, ...]:
        """The round's ``size`` scenes, in the batcher's local order
        (``SlotBatch.slot_scene`` indexes it), padded to ``size`` by
        repeating the first. All ids must share one bucket."""
        if not scene_ids:
            raise ValueError("stack needs at least one scene id")
        if size < len(scene_ids):
            raise ValueError(f"{len(scene_ids)} scenes do not fit a "
                             f"stack of {size}")
        entries = [self.get(i) for i in scene_ids]
        buckets = {e.bucket for e in entries}
        if len(buckets) > 1:
            raise ValueError(
                f"one round's scenes must share a bucket, got {buckets}")
        scenes = [e.scene for e in entries]
        return tuple(scenes + [scenes[0]] * (size - len(scenes)))

    def residency(self) -> Dict[Tuple[int, int], dict]:
        """Per-bucket residency: scenes resident, padded bytes held on the
        device, live stream refcounts (the ``scene_residency_*`` gauges)."""
        out: Dict[Tuple[int, int], dict] = {}
        for e in self._entries.values():
            r = out.setdefault(e.bucket, {"scenes": 0, "padded_bytes": 0,
                                          "refs": 0})
            r["scenes"] += 1
            r["padded_bytes"] += e.padded_bytes
            r["refs"] += e.refs
        return out

    def stats(self) -> dict:
        return {
            "scenes": len(self._entries),
            "registered": self.registered,
            "evicted": self.evicted,
            "buckets_in_use": list(self.buckets_in_use()),
            "padded_bytes": sum(e.padded_bytes
                                for e in self._entries.values()),
            "per_bucket": {str(b): r for b, r in self.residency().items()},
            "per_scene": {
                str(i): {"true_n": e.true_n, "bucket": e.bucket,
                         "refs": e.refs, "streams_seen": e.streams_seen,
                         "padded_bytes": e.padded_bytes}
                for i, e in self._entries.items()},
        }
