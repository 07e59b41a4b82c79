"""repro_torch.tuning — Random / TPE search and Hyperband (port of
``repro.tuning``; numpy only)."""
from repro_torch.tuning.tuner import (
    HyperbandResult,
    RandomSearch,
    TPESearch,
    hyperband,
    kendall_tau,
    sample_config,
    shape_bucketed_objective,
    stack_configs,
    subset_objective,
)

__all__ = [
    "HyperbandResult", "RandomSearch", "TPESearch", "hyperband", "kendall_tau",
    "sample_config", "shape_bucketed_objective", "stack_configs", "subset_objective",
]
