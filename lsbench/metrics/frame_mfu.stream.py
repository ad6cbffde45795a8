"""The whole frame's share of the card's peak, in %: the least time for
the preprocess and blend work the reference counts on the traced slice's
frames, over the frames' host-clock time. It still bounds a gain once a
kernel leaves the path."""


def read(obs):
    if obs.get("kind") != "stream" or "work" not in obs:
        return None
    sec = obs["frame_seconds"]
    return obs["work"]["frame_s"] / sec * 100.0 if sec > 0 else None
