"""A minimal functional module base for the radiance fields.

A module is a frozen dataclass of hyperparameters; its parameters live
outside it, in a nested dict. ``init(key, *args)`` runs a method once and
returns the parameters that method created, as ``{"params": {...}}``;
``apply(variables, *args, method=...)`` runs a method against given
parameters (jittable and differentiable: it only reads the dict).

Inside a method, ``self.param(name, init_fn, *init_args)`` creates (under
``init``) or reads (under ``apply``) one parameter, and
``self.child(name, module)`` binds a submodule to the nested dict
``name``. Parameters are created lazily, on first use, so a branch that
``init`` does not run creates nothing. The trees keep the layout the
fields have always had (``Dense_0/kernel``, ``level0/axis0``, ...), so
checkpoints written before this module existed still restore.

``Dense`` is the one layer the fields need.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

initializers = jax.nn.initializers


def _fold_in_path(key: jax.Array, path) -> jax.Array:
    """Fold a path of names and counters into ``key`` through one SHA-1
    of the path, the derivation the fields have always used, so a seed
    initializes the same values it did before this module existed."""
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        key, np.uint32(int.from_bytes(m.digest()[:4], "big"))
    )


class _Scope:
    """A path into a parameter dict. ``key`` is None under ``apply``;
    ``counters`` counts the parameters created under each path, which
    numbers their keys."""

    __slots__ = ("root", "key", "path", "counters")

    def __init__(self, root: dict, key: Optional[jax.Array], path=(),
                 counters: Optional[dict] = None):
        self.root = root
        self.key = key
        self.path = path
        self.counters = {} if counters is None else counters

    def push(self, name: str) -> "_Scope":
        return _Scope(self.root, self.key, self.path + (name,), self.counters)

    def param(self, name: str, init_fn: Callable, *init_args):
        node = self.root
        for part in self.path:
            if part not in node:
                if self.key is None:
                    missing = "/".join(self.path)
                    raise KeyError(f"no parameters under {missing}")
                node[part] = {}
            node = node[part]
        if name in node:
            return node[name]
        if self.key is None:
            full = "/".join(self.path + (name,))
            raise KeyError(f"missing parameter {full}")
        count = self.counters.get(self.path, 0) + 1
        self.counters[self.path] = count
        node[name] = init_fn(
            _fold_in_path(self.key, self.path + (count,)), *init_args
        )
        return node[name]


class Module:
    """Base class: every subclass becomes a frozen dataclass."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)

    def init(self, key: jax.Array, *args, method=None, **kwargs) -> dict:
        params: dict = {}
        self._run(_Scope(params, key), method, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, method=None, **kwargs):
        scope = _Scope(variables.get("params", {}), None)
        return self._run(scope, method, args, kwargs)

    def _run(self, scope: _Scope, method, args, kwargs):
        if method is None:
            fn = type(self).__call__
        elif isinstance(method, str):
            fn = getattr(type(self), method)
        else:  # a bound method of this (unbound) module, or a function
            fn = getattr(method, "__func__", method)
        return fn(self._bind(scope), *args, **kwargs)

    def _bind(self, scope: _Scope) -> "Module":
        bound = copy.copy(self)
        object.__setattr__(bound, "_scope", scope)
        return bound

    def param(self, name: str, init_fn: Callable, *init_args):
        return self._scope.param(name, init_fn, *init_args)

    def child(self, name: str, module: "Module") -> "Module":
        return module._bind(self._scope.push(name))


class Dense(Module):
    """``x @ kernel (+ bias)``; ``dtype`` is the compute dtype (inputs and
    parameters are cast to it), ``param_dtype`` the stored one."""

    features: int
    use_bias: bool = True
    dtype: Any = None
    param_dtype: Any = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        kernel = self.param(
            "kernel", self.kernel_init, (x.shape[-1], self.features),
            self.param_dtype,
        )
        dtype = self.dtype or jnp.result_type(x, kernel)
        y = jnp.dot(x.astype(dtype), kernel.astype(dtype))
        if self.use_bias:
            bias = self.param(
                "bias", self.bias_init, (self.features,), self.param_dtype
            )
            y = y + bias.astype(dtype)
        return y
