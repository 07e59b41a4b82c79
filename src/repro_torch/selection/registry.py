"""String-keyed selector registry (port of ``repro.selection.registry``).

Each strategy registers a name, a config dataclass, and a factory; callers
construct any selector uniformly::

    sel = build_selector("milo", metadata=md, total_epochs=40)

which is what lets ``MiloSession``, the benchmarks, and launch scripts swap
strategies from a single config string instead of ad-hoc constructor paths.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator

from repro_torch.selection.base import Selector


@dataclasses.dataclass(frozen=True)
class SelectorEntry:
    name: str
    config_cls: type
    factory: Callable[[Any], Selector]
    paper: str = ""      # name of the strategy in the MILO paper's experiments
    doc: str = ""


_REGISTRY: dict[str, SelectorEntry] = {}


def register(name: str, config_cls: type, *, paper: str = "", doc: str = ""):
    """Class decorator: ``@register("milo", MiloConfig, paper="MILO")``.

    The decorated class must accept the config dataclass instance as its
    single constructor argument.
    """

    def deco(cls):
        if name in _REGISTRY:
            raise ValueError(f"selector {name!r} already registered")
        _REGISTRY[name] = SelectorEntry(
            name=name,
            config_cls=config_cls,
            factory=cls,
            paper=paper,
            doc=doc or ((cls.__doc__ or "").strip().splitlines() or [""])[0],
        )
        cls.registry_name = name
        return cls

    return deco


def selector_entry(name: str) -> SelectorEntry:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown selector {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available_selectors() -> list[str]:
    return sorted(_REGISTRY)


def iter_entries() -> Iterator[SelectorEntry]:
    for name in available_selectors():
        yield _REGISTRY[name]


def build_selector(name: str, **cfg: Any) -> Selector:
    """Construct a registered selector from keyword config.

    ``cfg`` is validated against the strategy's config dataclass, so typos
    and missing required fields fail loudly at build time.
    """
    entry = selector_entry(name)
    try:
        config = entry.config_cls(**cfg)
    except TypeError as e:
        fields = [f.name for f in dataclasses.fields(entry.config_cls)]
        raise TypeError(
            f"bad config for selector {name!r}: {e}; expected fields {fields}"
        ) from None
    return entry.factory(config)
