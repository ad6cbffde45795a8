"""``StreamServer.step``'s wall ms per busy round over the measured
window (its ``render_seconds`` over its ``busy_rounds``)."""


def read(obs):
    if obs.get("kind") != "venue":
        return None
    return obs["round_s"] * 1e3
