"""Device ms per warped frame under the program's ``repro.frame/warp``
and ``repro.frame/compose`` ranges (``core.warp`` and the compose of
``core.pipeline.render_sparse_frame``), over the traced slice."""


def read(obs):
    if obs.get("kind") != "stream":
        return None
    st = obs["slice"].stage_s
    sec = st.get("repro.frame/warp", 0.0) + st.get("repro.frame/compose",
                                                   0.0)
    warped = sum(1 for _, kept, _ in obs["slice_frames"] if not kept["key"])
    return sec / warped * 1e3 if sec > 0 and warped else None
