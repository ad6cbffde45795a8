"""``serve.batcher``'s slot occupancy over the measured window, in %:
``StreamServer``'s real frames rendered over its slot-frames (B x chunk
summed over rendered groups)."""


def read(obs):
    if obs.get("kind") != "venue":
        return None
    return obs["slot_occupancy"] * 100.0
