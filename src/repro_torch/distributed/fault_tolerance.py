"""Fault-tolerance utilities (DESIGN.md §5; the port of the reference's
``distributed/fault_tolerance.py``, which imports no JAX: the port keeps
its own copy).

The concrete mechanisms live where they act:
  - atomic checkpoints ..................... train/checkpoint.py
  - auto-resume + step watchdog ............ launch/train.py
  - deterministic seekable data ............ train/data.py
  - elastic re-mesh on restore ............. train/checkpoint.py
                                             (``restore(shardings=)``)

This module adds the *decision* layer a 1000-node deployment needs:
classify a failure, pick an action, and (in tests) inject failures.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional


class FailureKind(enum.Enum):
    STEP_TIMEOUT = "step_timeout"        # straggler / hung collective
    DEVICE_LOST = "device_lost"          # pod or chip dropped
    NAN_LOSS = "nan_loss"                # numeric blowup
    CHECKPOINT_IO = "checkpoint_io"      # storage hiccup


@dataclasses.dataclass
class Policy:
    max_retries_per_step: int = 2
    nan_rollback_steps: int = 1          # restore N checkpoints back
    straggler_grace: float = 2.0         # x median step time
    remesh_on_device_loss: bool = True   # shrink mesh instead of waiting


def classify(exc: BaseException, *, step_s: Optional[float] = None,
             median_s: Optional[float] = None,
             policy: Policy = Policy()) -> FailureKind:
    name = type(exc).__name__.lower()
    msg = str(exc).lower()
    if "nan" in msg:
        return FailureKind.NAN_LOSS
    if any(k in msg for k in ("device", "slice", "halted", "ici")):
        return FailureKind.DEVICE_LOST
    if any(k in name for k in ("oserror", "ioerror")) or "no space" in msg:
        return FailureKind.CHECKPOINT_IO
    return FailureKind.STEP_TIMEOUT


def action_for(kind: FailureKind, policy: Policy = Policy()) -> str:
    """Decision table — what the 1000-node driver does per failure kind."""
    return {
        FailureKind.STEP_TIMEOUT: "retry step; after "
        f"{policy.max_retries_per_step} retries, exclude the slow host "
        "and re-mesh (checkpoint.restore with the smaller mesh's "
        "shardings)",
        FailureKind.DEVICE_LOST: "restore latest checkpoint onto the "
        "surviving mesh (elastic re-mesh) and continue; data cursor "
        "resumes from the checkpointed step",
        FailureKind.NAN_LOSS: f"roll back {policy.nan_rollback_steps} "
        "checkpoint(s), halve LR for the replayed window, continue",
        FailureKind.CHECKPOINT_IO: "keep training; retry the save with "
        "exponential backoff (atomic tmp+rename means no torn state)",
    }[kind]


class StepWatchdog:
    """Tracks step durations; flags stragglers at grace x running median."""

    def __init__(self, policy: Policy = Policy()):
        self.policy = policy
        self.durations: list = []
        self.flagged = 0

    def observe(self, seconds: float) -> bool:
        self.durations.append(seconds)
        n = len(self.durations)
        if n < 5:
            return False
        med = sorted(self.durations)[n // 2]
        if seconds > self.policy.straggler_grace * med:
            self.flagged += 1
            return True
        return False
