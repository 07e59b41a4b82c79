"""MILO core on PyTorch: similarity, set functions, greedy engines,
exploration, curriculum, artifacts, the preprocessing orchestrator and the
sharded engines.

Modules are imported directly (``repro_torch.core.milo`` and so on).  The
package exports ``preprocess_with_encoder`` and the sharded engines of
``core.sharded``, as the reference's does, but imports their modules only
when a name is first read, so that the numpy-only modules stay light.
"""

_SHARDED = (
    "make_sharded_gram_free",
    "sharded_greedy",
    "sharded_greedy_importance",
    "sharded_lazy_greedy",
    "sharded_refine",
    "sharded_sge",
    "sharded_stochastic_greedy",
)

__all__ = ["preprocess_with_encoder", *_SHARDED]


def __getattr__(name: str):
    if name == "preprocess_with_encoder":
        from repro_torch.core.milo import preprocess_with_encoder

        return preprocess_with_encoder
    if name in _SHARDED:
        from repro_torch.core import sharded

        return getattr(sharded, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
