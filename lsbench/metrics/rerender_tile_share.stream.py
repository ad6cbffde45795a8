"""Share of the tiles, in %, that a warped frame re-renders (its plan's
active tiles, ``FrameRecord.active``), averaged over the warped frames
of the traced slice: TWSR's saving is the rest."""


def read(obs):
    if obs.get("kind") != "stream" or "slice_frames" not in obs:
        return None
    shares = [float(kept["active"].float().mean())
              for _, kept, _ in obs["slice_frames"] if not kept["key"]]
    return sum(shares) / len(shares) * 100.0 if shares else None
