"""Should-proxy policies (paper Fig 2c: ``should_proxy=lambda x: ...``).

A policy decides, per task argument/result, whether the object is worth
routing through mediated storage instead of embedding it in the task
message.  Policies are picklable so executors can apply them worker-side
to results as well.

Built-in policies are registered by name in :data:`policy_registry` so
they can be *declared* (``PolicySpec("size", threshold=1_000_000)``) and
round-tripped through config dicts, mirroring the connector registry::

    policy = policy_from_config({"policy_type": "size", "threshold": 4096})
    policy.config()  # -> the same dict back
"""

from __future__ import annotations

import importlib
from typing import Any, Callable

from repro_torch.core.plugins import PluginRegistry
from repro_torch.core.serialize import estimate_size

Policy = Callable[[Any], bool]

# Types that are never worth proxying: cheaper inline than as a factory.
_NEVER_PROXY = (type(None), bool, int, float, complex)

policy_registry: PluginRegistry[type] = PluginRegistry("policy")


def register_policy(name: str):
    """Class decorator registering a policy type for config round-trips."""

    def deco(cls: type) -> type:
        policy_registry.register(name, cls)
        cls.policy_type = name
        return cls

    return deco


def list_policies() -> list[str]:
    """Names of every registered policy type."""
    return policy_registry.names()


def policy_from_config(config: dict[str, Any]) -> Policy:
    """Reconstruct a policy from its ``config()`` dict."""
    config = dict(config)
    kind = config.pop("policy_type")
    return policy_registry.get(kind).from_config(config)


@register_policy("size")
class SizePolicy:
    """Proxy objects whose estimated size is >= ``threshold`` bytes."""

    def __init__(self, threshold: int = 100_000):
        self.threshold = int(threshold)

    def __call__(self, obj: Any) -> bool:
        if isinstance(obj, _NEVER_PROXY):
            return False
        return estimate_size(obj) >= self.threshold

    def config(self) -> dict[str, Any]:
        return {"policy_type": "size", "threshold": self.threshold}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "SizePolicy":
        return cls(**config)

    def __repr__(self) -> str:
        return f"SizePolicy(threshold={self.threshold})"


@register_policy("type")
class TypePolicy:
    """Proxy instances of the given types.

    Types may be given as classes or as dotted ``module.QualName`` strings;
    strings are resolved lazily on first use, which keeps the policy
    picklable and its config JSON-clean.
    """

    def __init__(self, *types: type | str):
        self.type_names = tuple(
            t if isinstance(t, str) else f"{t.__module__}.{t.__qualname__}"
            for t in types
        )
        self._resolved: tuple[type, ...] | None = (
            tuple(t for t in types if not isinstance(t, str))
            if all(not isinstance(t, str) for t in types)
            else None
        )

    @property
    def types(self) -> tuple[type, ...]:
        if self._resolved is None:
            self._resolved = tuple(
                _resolve_dotted(name) for name in self.type_names
            )
        return self._resolved

    def __call__(self, obj: Any) -> bool:
        return isinstance(obj, self.types)

    def config(self) -> dict[str, Any]:
        return {"policy_type": "type", "types": list(self.type_names)}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "TypePolicy":
        return cls(*config.get("types", ()))

    def __getstate__(self) -> dict[str, Any]:
        # Ship names only: resolved classes may not pickle by reference.
        return {"type_names": self.type_names}

    def __setstate__(self, state: dict[str, Any]) -> None:
        self.type_names = tuple(state["type_names"])
        self._resolved = None

    def __repr__(self) -> str:
        return f"TypePolicy({', '.join(self.type_names)})"


def _resolve_dotted(name: str) -> type:
    module, _, qualname = name.rpartition(".")
    obj: Any = importlib.import_module(module or "builtins")
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


class _CompositePolicy:
    def __init__(self, *policies: Policy):
        self.policies = tuple(policies)

    def config(self) -> dict[str, Any]:
        return {
            "policy_type": self.policy_type,
            "policies": [_policy_config(p) for p in self.policies],
        }

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "_CompositePolicy":
        return cls(*(policy_from_config(c) for c in config.get("policies", ())))

    def __repr__(self) -> str:
        return f"{type(self).__name__}({', '.join(map(repr, self.policies))})"


def _policy_config(policy: Policy) -> dict[str, Any]:
    cfg = getattr(policy, "config", None)
    if cfg is None:
        raise TypeError(
            f"policy {policy!r} has no config() and cannot be nested in a "
            "declarative composite; register it with @register_policy"
        )
    return cfg()


@register_policy("all")
class AllPolicy(_CompositePolicy):
    def __call__(self, obj: Any) -> bool:
        return all(p(obj) for p in self.policies)


@register_policy("any")
class AnyPolicy(_CompositePolicy):
    def __call__(self, obj: Any) -> bool:
        return any(p(obj) for p in self.policies)


@register_policy("never")
class NeverPolicy:
    def __call__(self, obj: Any) -> bool:
        return False

    def config(self) -> dict[str, Any]:
        return {"policy_type": "never"}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "NeverPolicy":
        return cls()


@register_policy("always")
class AlwaysPolicy:
    def __call__(self, obj: Any) -> bool:
        return not isinstance(obj, _NEVER_PROXY)

    def config(self) -> dict[str, Any]:
        return {"policy_type": "always"}

    @classmethod
    def from_config(cls, config: dict[str, Any]) -> "AlwaysPolicy":
        return cls()
