"""Share of an untraced training step, in %, in which no device
operation ran: 1 - the traced steps' device time (the union of their
operations) a step, over the median of the window's untraced step times.
The traced steps' own wall time is not the divisor: the profiler slows
the host that launches them, and the device would read idle for it."""
import statistics


def read(obs):
    if obs.get("kind") != "lm_train" or "slice" not in obs \
            or obs["slice"].busy_s <= 0:
        return None
    busy = obs["slice"].busy_s / obs["traced_steps"]
    return (1.0 - busy / statistics.median(obs["step_seconds"])) * 100.0
