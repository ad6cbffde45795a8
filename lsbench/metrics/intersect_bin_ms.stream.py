"""Device ms per frame under the program's ``repro.frame/intersect`` and
``repro.frame/bin`` ranges (``core.pipeline.intersect_and_bin``), over
the traced slice of whole key-frame windows of a single-viewer stream."""


def read(obs):
    if obs.get("kind") != "stream":
        return None
    st = obs["slice"].stage_s
    sec = st.get("repro.frame/intersect", 0.0) + st.get("repro.frame/bin",
                                                        0.0)
    return sec / len(obs["slice_frames"]) * 1e3 if sec > 0 else None
