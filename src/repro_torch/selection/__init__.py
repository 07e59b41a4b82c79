"""repro_torch.selection — the front door for subset selection on PyTorch.

* ``SelectionPlan`` / ``Selector`` — the weighted per-epoch protocol.
* ``build_selector(name, **cfg)`` — registry factory over the reference's
  twelve strategies (MILO's four and the paper's baselines).
* ``MiloSession`` — one-call facade: ``preprocess()`` / ``train()`` /
  ``tune()``.
"""
from repro_torch.selection.plan import PHASES, SelectionPlan, uniform_plan
from repro_torch.selection.base import Selector
from repro_torch.selection.registry import (
    available_selectors,
    build_selector,
    register,
    selector_entry,
)
from repro_torch.selection.selectors import (
    AdaptiveRandomConfig,
    CraigPBConfig,
    EL2NConfig,
    FullConfig,
    GlisterConfig,
    GradMatchPBConfig,
    MiloConfig,
    MiloFixedConfig,
    MiloHierConfig,
    MiloTargetedConfig,
    RandomConfig,
    SelfSupPruneConfig,
)
from repro_torch.selection.session import MiloSession, MiloSessionConfig, TrainReport

__all__ = [
    "PHASES", "SelectionPlan", "Selector", "uniform_plan", "available_selectors",
    "build_selector", "register", "selector_entry", "AdaptiveRandomConfig",
    "CraigPBConfig", "EL2NConfig", "FullConfig", "GlisterConfig", "GradMatchPBConfig",
    "MiloConfig", "MiloFixedConfig", "MiloHierConfig", "MiloTargetedConfig",
    "RandomConfig", "SelfSupPruneConfig", "MiloSession", "MiloSessionConfig",
    "TrainReport",
]
