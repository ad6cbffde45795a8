"""Continuous batching: churning sessions -> fixed (B, F) engine batches
(port of ``repro/serve/batcher.py``).

The batcher keeps B slots. Each round it binds waiting sessions to free
slots, pops up to ``chunk`` pending poses per bound session into a dense
(B, chunk, 4, 4) batch, and masks everything else: a slot with fewer
pending poses gets a shorter ``count`` (the engine freezes its carry past
the count, so the key-frame schedule resumes where it paused), and an
unbound slot rides along with ``count=0`` and is not rendered. Active
streams render exactly as a solo ``render_trajectory`` would.

- **scene-aware packing.** Sessions carry a ``scene_id``; ``admit`` packs
  same-scene streams into contiguous slot groups of ``group`` slots and
  ``build`` emits ``slot_scene`` — per-slot indices into the round's
  distinct ``scene_ids``. Idle slots reuse local scene 0.
- **elastic B.** ``resize`` grows or shrinks the slot count between
  rounds. Shrinking unbinds the sessions in the removed slots; their
  carries live on the session, so they resume later unchanged.

``build`` pops poses (and their enqueue stamps) out of the sessions;
``commit`` writes back the final carries, stamps per-frame latencies,
optionally keeps rendered frames on the session (``collect_frames``), and
releases slots of drained-and-closed sessions.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.core import engine
from repro_torch.core.camera import Camera
from repro_torch.core.engine import EngineCarry, StreamsResult
from repro_torch.obs.trace import PROCESS_TRACER, Tracer
from repro_torch.serve.session import SessionManager

_EYE = np.eye(4, dtype=np.float32)


class SlotBatch(NamedTuple):
    """One round's dense engine input plus the host-side bookkeeping.
    ``poses`` and ``carries`` live on the camera's device; the small
    per-slot arrays stay on the host."""

    poses: torch.Tensor     # (B, F, 4, 4)
    counts: torch.Tensor    # (B,) int32 active-frame counts
    phases: torch.Tensor    # (B,) int32 per-slot key-frame phases
    carries: EngineCarry    # stacked (B, ...) resume carries
    sids: Tuple[Optional[int], ...]          # slot -> session id (or None)
    enq_times: Tuple[Tuple[float, ...], ...]  # per-slot popped stamps
    slot_scene: torch.Tensor  # (B,) int32 index into scene_ids (idle -> 0)
    scene_ids: Tuple[Optional[int], ...]  # round's distinct scenes, local order

    @property
    def active_frames(self) -> int:
        return int(self.counts.sum())

    @property
    def bound_slots(self) -> int:
        return sum(s is not None for s in self.sids)


class ContinuousBatcher:
    """Scene-aware B-slot batcher over ``engine.render_streams``."""

    def __init__(self, slots: int, chunk: int, cam: Camera, *,
                 group: Optional[int] = None,
                 collect_frames: bool = False,
                 bucket: Optional[Tuple[int, int]] = None,
                 n_gaussians: Optional[int] = None,
                 tracer: Optional[Tracer] = None):
        if slots < 1 or chunk < 1:
            raise ValueError(f"need slots >= 1 and chunk >= 1, got "
                             f"{slots}, {chunk}")
        self.slots = int(slots)
        self.chunk = int(chunk)
        self.cam = cam
        # The scene bucket this batcher's slot group serves (None for the
        # single-bucket use); it names the group in traces and reprs.
        self.bucket = bucket
        # Contiguity granularity for same-scene packing (the per-device
        # shard size); None -> one group.
        self.group = int(group) if group else self.slots
        self.collect_frames = bool(collect_frames)
        # The scenes' Gaussian count, required when the config threads the
        # contribution prior (pipeline.contrib_enabled); None otherwise.
        self.n_gaussians = n_gaussians
        self.tracer = PROCESS_TRACER if tracer is None else tracer
        self._slot_sid: List[Optional[int]] = [None] * self.slots
        # Idle slots are all identical (count 0, eye pose, zero state).
        self._idle_carry = engine.init_carry(cam, _EYE, n_gaussians)

    @property
    def bound(self) -> int:
        return sum(s is not None for s in self._slot_sid)

    def __repr__(self) -> str:
        return (f"ContinuousBatcher(slots={self.slots}, "
                f"chunk={self.chunk}, bound={self.bound}, "
                f"bucket={self.bucket})")

    def bound_sids(self) -> List[int]:
        """Session ids currently bound to a slot, slot order."""
        return [s for s in self._slot_sid if s is not None]

    # -- elastic B ---------------------------------------------------------
    def resize(self, new_slots: int, manager: SessionManager, *,
               group: Optional[int] = None) -> List[int]:
        """Grow/shrink the slot batch between rounds. Shrinking unbinds
        sessions in slots >= ``new_slots``; they rejoin
        ``manager.waiting()`` with their carries. Returns the unbound
        session ids."""
        if new_slots < 1:
            raise ValueError(f"need slots >= 1, got {new_slots}")
        self.tracer.instant("resize", track=f"bucket {self.bucket}",
                            args={"from": self.slots, "to": int(new_slots)})
        unbound: List[int] = []
        for i in range(new_slots, self.slots):
            sid = self._slot_sid[i]
            if sid is None:
                continue
            sess = manager.sessions.get(sid)
            if sess is not None:
                sess.slot = None
            unbound.append(sid)
        self._slot_sid = self._slot_sid[:new_slots] + \
            [None] * max(0, new_slots - self.slots)
        self.slots = int(new_slots)
        self.group = int(group) if group else self.slots
        return unbound

    # -- admission ---------------------------------------------------------
    def _slot_groups(self) -> List[range]:
        g = max(1, min(self.group, self.slots))
        return [range(s, min(s + g, self.slots))
                for s in range(0, self.slots, g)]

    def _pick_slot(self, scene_id, manager: SessionManager) -> Optional[int]:
        """Free slot preference: a group already serving ``scene_id`` >
        a fully-free group > any free slot (lowest index per tier)."""
        same = empty = anywhere = None
        for grp in self._slot_groups():
            free = [i for i in grp if self._slot_sid[i] is None]
            if not free:
                continue
            occupied = [self._slot_sid[i] for i in grp
                        if self._slot_sid[i] is not None]
            scenes_in = {manager.sessions[s].scene_id for s in occupied
                         if s in manager.sessions}
            if scene_id in scenes_in and same is None:
                same = free[0]
            if not occupied and empty is None:
                empty = free[0]
            if anywhere is None:
                anywhere = free[0]
        if same is not None:
            return same
        return empty if empty is not None else anywhere

    def admit(self, manager: SessionManager,
              allowed: Optional[Set] = None) -> int:
        """Bind waiting sessions (oldest first) to free slots, packing
        same-scene streams into contiguous groups. ``allowed`` restricts
        admission to sessions of those scene_ids."""
        admitted = 0
        for sess in manager.waiting():
            if allowed is not None and sess.scene_id not in allowed:
                continue
            i = self._pick_slot(sess.scene_id, manager)
            if i is None:
                break
            sess.slot = i
            self._slot_sid[i] = sess.sid
            admitted += 1
        return admitted

    # -- batch assembly ----------------------------------------------------
    def _batch(self, poses: np.ndarray, counts, phases, carries, sids,
               stamps, slot_scene, scene_ids) -> SlotBatch:
        dev = self.cam.device
        i32 = dict(dtype=torch.int32)
        return SlotBatch(poses=torch.as_tensor(poses, device=dev),
                         counts=torch.as_tensor(counts, **i32),
                         phases=torch.as_tensor(phases, **i32),
                         carries=engine.stack_carries(carries),
                         sids=tuple(sids), enq_times=tuple(stamps),
                         slot_scene=torch.as_tensor(slot_scene, **i32),
                         scene_ids=tuple(scene_ids))

    def empty_batch(self, slots: Optional[int] = None) -> SlotBatch:
        """An all-idle (count-0) batch that touches no session state.
        ``slots`` overrides the batch size."""
        b, f = self.slots if slots is None else int(slots), self.chunk
        zeros = np.zeros((b,), np.int32)
        return self._batch(np.tile(_EYE, (b, f, 1, 1)), zeros, zeros,
                           [self._idle_carry] * b, (None,) * b, ((),) * b,
                           zeros, ())

    def build(self, manager: SessionManager) -> SlotBatch:
        """Pop up to ``chunk`` poses per bound session into a dense batch."""
        b, f = self.slots, self.chunk
        poses = np.tile(_EYE, (b, f, 1, 1))
        counts = np.zeros((b,), np.int32)
        phases = np.zeros((b,), np.int32)
        slot_scene = np.zeros((b,), np.int32)
        scene_ids: List[Optional[int]] = []
        scene_local: dict = {}
        carries: List[EngineCarry] = []
        sids: List[Optional[int]] = []
        stamps: List[Tuple[float, ...]] = []
        for i, sid in enumerate(self._slot_sid):
            sess = manager.sessions.get(sid) if sid is not None else None
            if sid is not None and sess is None:
                # Detached externally since the last round: free the slot
                # now (commit only handles cancellation mid-flight).
                self._slot_sid[i] = sid = None
            slot_stamps: List[float] = []
            if sess is not None:
                phases[i] = sess.phase
                if sess.scene_id not in scene_local:
                    scene_local[sess.scene_id] = len(scene_ids)
                    scene_ids.append(sess.scene_id)
                slot_scene[i] = scene_local[sess.scene_id]
                k = 0
                while sess.pending and k < f:
                    pose, t_enq = sess.pending.popleft()
                    poses[i, k] = pose
                    slot_stamps.append(t_enq)
                    k += 1
                counts[i] = k
                if k:
                    poses[i, k:] = poses[i, k - 1]
                if sess.carry is None:
                    sess.carry = engine.init_carry(self.cam, poses[i, 0],
                                                   self.n_gaussians)
                carries.append(sess.carry)
                sids.append(sid)
            else:
                carries.append(self._idle_carry)
                sids.append(None)
            stamps.append(tuple(slot_stamps))
        return self._batch(poses, counts, phases, carries, sids, stamps,
                           slot_scene, scene_ids)

    def commit(self, batch: SlotBatch, result: StreamsResult,
               manager: SessionManager, now: float) -> List["StreamSession"]:
        """Write back carries/latencies; detach drained sessions.

        Returns the sessions detached this round (their slots free up for
        the next ``admit``; the server keeps them for final stats).
        """
        detached: List = []
        carries = engine.unstack_carries(result.carries)
        counts = batch.counts.tolist()
        for i, sid in enumerate(batch.sids):
            if sid is None:
                continue
            if sid not in manager.sessions:
                # Cancelled externally (manager.detach) mid-flight: the
                # rendered chunk has no consumer, but the slot must not
                # leak.
                if self._slot_sid[i] == sid:
                    self._slot_sid[i] = None
                continue
            sess = manager.sessions[sid]
            sess.carry = carries[i]
            n = counts[i]
            sess.frames_rendered += n
            if self.collect_frames and n:
                sess.frames.append(result.frames[i, :n].clone())
            sess.latencies.extend(now - t for t in batch.enq_times[i][:n])
            if sess.done:
                manager.detach(sid)
                sess.slot = None
                self._slot_sid[i] = None
                detached.append(sess)
        return detached
