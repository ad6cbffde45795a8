"""Share of the traced slice's wall time, in %, in which no device
operation ran (single-viewer stream)."""


def read(obs):
    if obs.get("kind") != "stream" or "slice" not in obs:
        return None
    sl = obs["slice"]
    return (1.0 - sl.busy_s / sl.wall_s) * 100.0 if sl.busy_s > 0 else None
