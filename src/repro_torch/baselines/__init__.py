"""repro_torch.baselines — the model-independent baseline strategies ported
so far (``MiloFixedSelector``); the others wait for ROADMAP A9."""
from repro_torch.baselines.selectors import MiloFixedSelector

__all__ = ["MiloFixedSelector"]
