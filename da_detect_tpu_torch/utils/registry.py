"""Name -> factory registry (port of ``da_detect_tpu/utils/registry.py``).

A ``dict`` whose ``register(name, obj)`` refuses a name twice; without
``obj`` it returns a decorator that registers the decorated function."""

from __future__ import annotations


class Registry(dict):
    def register(self, name: str, obj=None):
        if obj is not None:
            if name in self:
                raise KeyError(f"{name} already registered")
            self[name] = obj
            return obj

        def deco(fn):
            self.register(name, fn)
            return fn

        return deco
