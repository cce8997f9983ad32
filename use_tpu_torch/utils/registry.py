"""Name -> class registries.

Mirrors the registry facility of the reference
(src/models/components/sgmse/util/registry.py:5-36): a tiny mapping with
decorator-based registration and a warning on double registration.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List


class Registry:
    def __init__(self, managed_thing: str):
        self.managed_thing = managed_thing
        self._registry: Dict[str, Any] = {}

    def register(self, name: str) -> Callable:
        def inner(thing: Any) -> Any:
            if name in self._registry:
                warnings.warn(
                    f"{self.managed_thing} '{name}' doubly registered; overwriting.",
                    stacklevel=2,
                )
            self._registry[name] = thing
            return thing

        return inner

    def get_by_name(self, name: str) -> Any:
        if name not in self._registry:
            raise ValueError(
                f"{self.managed_thing} '{name}' unknown. "
                f"Available: {sorted(self._registry)}"
            )
        return self._registry[name]

    def get_all_names(self) -> List[str]:
        return sorted(self._registry)

    def __contains__(self, name: str) -> bool:
        return name in self._registry
