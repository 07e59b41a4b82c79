"""Test-support utilities shipped with the library (port of
``repro.testing``).

``repro_torch.testing.faults`` is the deterministic fault-injection
harness: process kills at a chosen training step, scripted failures of any
callable, slow steps, NaN steps, poisoned features and checkpoint
corruption — all counter-driven, never random, so every injected failure
is replayable.
"""
from repro_torch.testing.faults import (
    FaultInjected,
    KillAtStep,
    TransientFault,
    corrupt_checkpoint,
    fail_nth_calls,
    flaky,
    slow_steps,
)

__all__ = [
    "FaultInjected",
    "KillAtStep",
    "TransientFault",
    "corrupt_checkpoint",
    "fail_nth_calls",
    "flaky",
    "slow_steps",
]
