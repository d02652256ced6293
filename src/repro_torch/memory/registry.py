"""Method registry: agent run-strategies as registered classes (the twin of
``repro.memory.registry``).

A method is a class decorated with :func:`register_method`; the agent
resolves it by name, and the harness enumerates :func:`method_names`. The
registry stores classes keyed by name and knows nothing of agents; the
strategies live in ``repro_torch.core.methods`` (importing that module
populates the registry).
"""

from __future__ import annotations

from typing import Any, Dict, List, Type


class AgentMethod:
    """One run strategy bound to one agent deployment.

    Subclass, decorate with ``@register_method(name)``, implement
    ``run(task) -> RunRecord``. ``setup()`` runs once at agent construction
    for per-deployment state (e.g. the semantic baseline's query store),
    before the agent builds its default store.
    """

    name = ""  # set by register_method

    def __init__(self, agent: Any):
        self.agent = agent
        self.setup()

    def setup(self) -> None:
        pass

    def run(self, task: Any):
        raise NotImplementedError


METHOD_REGISTRY: Dict[str, Type[AgentMethod]] = {}


def register_method(name: str):
    """Class decorator: register an :class:`AgentMethod` under ``name``."""

    def deco(cls: Type[AgentMethod]) -> Type[AgentMethod]:
        if not (isinstance(cls, type) and issubclass(cls, AgentMethod)):
            raise TypeError(f"{cls!r} is not an AgentMethod subclass")
        cls.name = name
        METHOD_REGISTRY[name] = cls
        return cls

    return deco


def get_method_class(name: str) -> Type[AgentMethod]:
    try:
        return METHOD_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered: {sorted(METHOD_REGISTRY)}"
        ) from None


def make_method(name: str, agent: Any) -> AgentMethod:
    return get_method_class(name)(agent)


def method_names() -> List[str]:
    """Registered method names, in registration order."""
    return list(METHOD_REGISTRY)


__all__ = [
    "METHOD_REGISTRY",
    "AgentMethod",
    "get_method_class",
    "make_method",
    "method_names",
    "register_method",
]
