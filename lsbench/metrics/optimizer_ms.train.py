"""Device ms a training step under the program's ``repro.train/optimizer``
range (``train.train_step``'s call of ``optimizer.adamw_update``: the
clip norm and the update), over the traced steps. None where the trace
holds no such range."""


def read(obs):
    if obs.get("kind") != "lm_train" or "slice" not in obs:
        return None
    sec = obs["slice"].stage_s.get("repro.train/optimizer", 0.0)
    return sec / obs["traced_steps"] * 1e3 if sec > 0 else None
