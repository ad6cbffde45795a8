"""Operations that made the host wait for the device, per frame, over one
key-frame window under torch's CUDA sync debug mode (a count)."""


def read(obs):
    if obs.get("kind") != "stream" or "syncs" not in obs:
        return None
    return obs["syncs"] / obs["sync_frames"]
