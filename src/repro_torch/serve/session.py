"""Stream sessions: attach/detach lifecycle and key-frame phase assignment
(port of ``repro/serve/session.py``).

A ``StreamSession`` is one camera stream against one scene: a queue of
pending poses (with enqueue timestamps for latency accounting), the
engine carry that resumes it mid-trajectory, the ``scene_id`` keying it
to a registry entry (``serve/scenes.py`` — None means the server's
default scene), and the key-frame ``phase`` that decides which steps
re-render fully.

Phase assignment is the churn-safe version of ``engine.stream_phases``:
that helper staggers a *static* batch evenly over ``[0, window)``; here
streams arrive and leave at arbitrary times, so the manager tracks how
many live sessions occupy each phase and hands a new stream the
least-loaded one (lowest index on ties — an empty manager therefore
deals phases 0, 1, 2, ... exactly like ``stream_phases``). Detaching
releases the phase, so long-running servers keep full renders staggered
instead of drifting into lockstep spikes.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.engine import EngineCarry

LATENCY_KEEP = 4096  # most recent per-frame latency samples per stream


@dataclasses.dataclass
class StreamSession:
    """One attached camera stream (see module docstring)."""

    sid: int
    phase: int
    pending: Deque[Tuple[np.ndarray, float]]  # (pose (4,4), enqueue time)
    attached_at: float
    scene_id: Optional[int] = None        # registry key (None = default)
    slo: Optional[str] = None             # SLO class name (None = default;
    #                                       serve/admission.py resolves it)
    carry: Optional[EngineCarry] = None   # None until the first chunk
    slot: Optional[int] = None            # batcher slot, None = waiting
    frames_rendered: int = 0
    # Rendered chunks (F_i, H, W, 3) tensors, newest last — only populated
    # when the batcher was built with collect_frames=True (parity tests,
    # demos); a production server leaves this off so memory stays flat.
    frames: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # Recent per-frame latencies (bounded: a live stream never detaches,
    # so an unbounded list would grow for the life of the server).
    latencies: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=LATENCY_KEEP))
    closed: bool = False                  # no more poses will be submitted

    @property
    def done(self) -> bool:
        """Drained and closed — eligible for detach by the serve loop."""
        return self.closed and not self.pending

    def submit(self, poses, now: float) -> None:
        """Enqueue (F, 4, 4) poses stamped with ``now``."""
        if self.closed:
            raise ValueError(f"stream {self.sid} is closed")
        if isinstance(poses, torch.Tensor):
            poses = poses.detach().cpu().numpy()
        poses = np.asarray(poses, np.float32)
        for f in range(poses.shape[0]):
            self.pending.append((poses[f], now))


class SessionManager:
    """Attach/detach registry with phase-load-balanced key-frame offsets."""

    def __init__(self, window: int):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = int(window)
        self.sessions: Dict[int, StreamSession] = {}
        self._phase_load = [0] * self.window
        self._next_sid = 0

    def _assign_phase(self) -> int:
        return int(np.argmin(self._phase_load))

    def attach(self, poses=None, *, now: float = 0.0,
               closed: bool = True,
               scene_id: Optional[int] = None,
               slo: Optional[str] = None) -> StreamSession:
        """Register a stream; optionally seed its pose queue.

        ``closed=True`` (the default) marks the trajectory complete at
        attach time — the session auto-detaches once drained. Pass
        ``closed=False`` for live streams that keep ``submit``-ing.
        ``scene_id`` keys the stream to a registry scene (None: the
        server substitutes its default scene); ``slo`` names a service
        class (serve/admission.py — None: the default class). Phase
        assignment stays scene-agnostic on purpose — the stagger
        balances *device* load and the device is shared across scenes.
        """
        sid = self._next_sid
        self._next_sid += 1
        phase = self._assign_phase()
        self._phase_load[phase] += 1
        sess = StreamSession(sid=sid, phase=phase, pending=deque(),
                             attached_at=now, scene_id=scene_id, slo=slo)
        if poses is not None:
            sess.submit(poses, now)
        if closed and not sess.pending:
            # A closed stream with nothing to render would never be
            # bound to a slot, so nothing would ever detach it.
            self._phase_load[phase] -= 1
            raise ValueError("closed stream attached without poses")
        sess.closed = closed
        self.sessions[sid] = sess
        return sess

    def detach(self, sid: int) -> StreamSession:
        sess = self.sessions.pop(sid)
        self._phase_load[sess.phase] -= 1
        return sess

    def waiting(self) -> List[StreamSession]:
        """Sessions with work but no batcher slot, oldest first."""
        return [s for s in self.sessions.values()
                if s.slot is None and s.pending]

    def by_scene(self, scene_id: Optional[int]) -> List[StreamSession]:
        """Live sessions keyed to ``scene_id``, attach order."""
        return [s for s in self.sessions.values()
                if s.scene_id == scene_id]

    def __len__(self) -> int:
        return len(self.sessions)
