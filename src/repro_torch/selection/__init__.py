"""repro_torch.selection — the front door for subset selection on PyTorch.

* ``SelectionPlan`` / ``Selector`` — the weighted per-epoch protocol;
  ``ensure_selector`` / ``LegacySelectorAdapter`` adapt objects that speak
  only the legacy ``indices_for_epoch`` protocol.
* ``build_selector(name, **cfg)`` — registry factory over the reference's
  twelve strategies (MILO's four and the paper's baselines).
* ``MiloSession`` — one-call facade: ``preprocess()`` / ``train()`` /
  ``tune()``.
"""
from repro_torch.selection.plan import PHASES, SelectionPlan, uniform_plan
from repro_torch.selection.base import LegacySelectorAdapter, Selector, ensure_selector
from repro_torch.selection.registry import (
    SelectorEntry,
    available_selectors,
    build_selector,
    iter_entries,
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
    "PHASES", "SelectionPlan", "Selector", "SelectorEntry", "LegacySelectorAdapter",
    "ensure_selector", "uniform_plan", "available_selectors", "build_selector",
    "iter_entries", "register", "selector_entry", "AdaptiveRandomConfig",
    "CraigPBConfig", "EL2NConfig", "FullConfig", "GlisterConfig", "GradMatchPBConfig",
    "MiloConfig", "MiloFixedConfig", "MiloHierConfig", "MiloTargetedConfig",
    "RandomConfig", "SelfSupPruneConfig", "MiloSession", "MiloSessionConfig",
    "TrainReport",
]
