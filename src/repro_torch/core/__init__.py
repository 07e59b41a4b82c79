"""MILO core on PyTorch: similarity, set functions, greedy engines,
exploration, curriculum, artifacts, the preprocessing orchestrator and the
sharded engines.

The package exports every name the reference's ``repro.core`` exports
(``from repro_torch.core import MiloPreprocessor``), but imports a name's
module only when the name is first read, so that ``import
repro_torch.core`` and the numpy-only modules stay light.
"""
from __future__ import annotations

import importlib

#: module of ``repro_torch.core`` -> the names it exports through the package
_EXPORTS = {
    "curriculum": ("CurriculumConfig",),
    "exploration": ("SGEBank", "WREDistribution", "build_wre", "taylor_softmax",
                    "weighted_sample_without_replacement"),
    "gram_free": ("get_gram_free", "make_gram_free_disparity_min",
                  "make_gram_free_disparity_sum", "make_gram_free_facility_location",
                  "make_gram_free_graph_cut", "make_query_facility_location"),
    "greedy": ("GreedyResult", "LazyGreedyResult", "greedy", "greedy_importance",
               "lazy_greedy", "refine", "sge", "stochastic_greedy"),
    "partition": ("BalancedBlocks", "ByClass", "PARTITION_STRATEGIES", "Partition",
                  "PartitionStrategy", "RandomBlocks", "make_partition_strategy",
                  "merge_class_selections", "partition_by_class", "proportional_budgets"),
    "sharded": ("make_sharded_gram_free", "sharded_greedy", "sharded_greedy_importance",
                "sharded_lazy_greedy", "sharded_refine", "sharded_sge",
                "sharded_stochastic_greedy"),
    "metadata": ("MiloMetadata", "is_preprocessed"),
    "milo": ("MiloPreprocessor", "MiloSelector", "hierarchical_select",
             "preprocess_with_encoder", "targeted_select"),
    "similarity": ("gram_matrix", "gram_matrix_blocked"),
    "submodular": ("SetFunction", "disparity_min", "disparity_sum", "facility_location",
                   "graph_cut", "make_graph_cut"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(__all__))
