"""The traffic is the same for every seed and open-loop in time."""
from collections import deque
from types import SimpleNamespace

import numpy as np

from lsbench import harness, venue
from lsbench.scene import Sessions


def _mix(name):
    return harness.mix(name)


def test_sessions_are_the_same_for_every_seed_and_differ_by_viewer():
    mix = _mix("walk")
    a = [Sessions(mix).next() for _ in range(2)]
    b = [Sessions(mix).next() for _ in range(2)]
    c = [Sessions(mix, stream=3).next() for _ in range(2)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0][:10], c[0][:10])


def test_sessions_spread_over_their_lengths():
    mix = _mix("walk")
    for stream in (0, 5):
        s = Sessions(mix, stream)
        lens = [s.next().shape[0] for _ in range(40)]
        lo, hi = mix["session_poses"]
        assert lo <= min(lens) and max(lens) <= hi
        assert abs(np.mean(lens) - (lo + hi) / 2) < 0.1 * (hi - lo)


def test_turn_orbits_four_degrees_a_frame():
    poses = Sessions(_mix("turn")).next()
    fwd = poses[:, 2, :3]
    ang = np.degrees(np.arccos(np.clip((fwd[1:] * fwd[:-1]).sum(1), -1, 1)))
    assert np.allclose(ang, 4.0, atol=0.3)


class _Session:
    def __init__(self, sid, poses, now):
        self.sid, self.pending, self.closed = sid, deque(), True
        self.frames_rendered, self.frames = 0, []
        self.submit(poses, now)

    def submit(self, poses, now):
        for p in poses:
            self.pending.append((p, now))


class _Server:
    """Never renders: the loop must offer load by the clock alone."""

    def __init__(self):
        self.now = 100.0
        self.sessions = []
        self.manager = SimpleNamespace(sessions={})

    def clock(self):
        return self.now

    def try_attach(self, poses, now):
        s = _Session(len(self.sessions), poses, now)
        self.sessions.append(s)
        return s


def test_venue_offers_poses_at_their_due_times_whatever_the_server_does():
    mix = dict(_mix("venue"), viewers=4, offered_frames_per_s=8.0)
    srv = _Server()
    v = venue.Venue(srv, mix, mix["offered_frames_per_s"])
    srv.now += 10.0
    v.submit_due(srv.now)
    period = 4 / 8.0
    expected = sorted(100.0 + i * period / 4 + k * period
                      for i in range(4)
                      for k in range(int((10.0 - i * period / 4) / period)
                                     + 1))
    due = sorted(t for s in v.served for t in s.due)
    # 8 poses a second over 4 viewers, first ticks staggered over one
    # period, each stamped with its due time; none was rendered.
    assert np.allclose(due, expected)
    stamps = sorted(t for s in srv.sessions for _, t in s.pending)
    assert stamps == due


def test_refused_frames_count_as_due_and_failed():
    mix = dict(_mix("venue"), viewers=2, offered_frames_per_s=4.0)
    srv = _Server()
    srv.try_attach = lambda poses, now: None
    v = venue.Venue(srv, mix, mix["offered_frames_per_s"])
    srv.now += 5.0
    v.submit_due(srv.now)
    lat, due, done = venue.latencies(v, srv.now + 1.0)
    assert due == len(v.refused) > 0
    assert lat == [] and done == 0
