"""MILO core on PyTorch: similarity, set functions, greedy engines,
exploration, curriculum, artifacts and the preprocessing orchestrator.

Modules are imported directly (``repro_torch.core.milo`` and so on).  The
package exports ``preprocess_with_encoder``, as the reference's does, but
imports its module only when the name is first read, so that the
numpy-only modules stay light.
"""

__all__ = ["preprocess_with_encoder"]


def __getattr__(name: str):
    if name == "preprocess_with_encoder":
        from repro_torch.core.milo import preprocess_with_encoder

        return preprocess_with_encoder
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
