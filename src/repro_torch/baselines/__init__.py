"""repro_torch.baselines — the paper's baseline strategies (port of
``repro.baselines``), the legacy ``indices_for_epoch`` classes."""
from repro_torch.baselines.selectors import (
    AdaptiveRandomSelector,
    CraigPBSelector,
    EL2NSelector,
    GlisterSelector,
    GradMatchPBSelector,
    MiloFixedSelector,
    RandomSelector,
    SelfSupPruneSelector,
)

__all__ = [
    "AdaptiveRandomSelector", "CraigPBSelector", "EL2NSelector", "GlisterSelector",
    "GradMatchPBSelector", "MiloFixedSelector", "RandomSelector", "SelfSupPruneSelector",
]
