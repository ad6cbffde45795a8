"""The whole training step's share of the card's bf16 peak, in %: the
step's operations (``peaks.lm_train_flops``: 6 a weight a token meets
and the causal attention products, recomputation not counted) times the
window's steps, over their host-clock time (each step from its call to
the synchronize after it, untraced) and 989 TFLOP/s: ``tokens_per_s``
times a constant. Read only where the trace saw the device work. It
still bounds a gain once a kernel leaves the path."""
from lsbench import peaks


def read(obs):
    if obs.get("kind") != "lm_train" or "slice" not in obs \
            or obs["slice"].busy_s <= 0:
        return None
    steps = obs["step_seconds"]
    flops = obs["flops_per_step"] * len(steps)
    return flops / sum(steps) / peaks.BF16_FLOPS_PER_S * 100.0
