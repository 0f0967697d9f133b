"""Tiny pure-pytree module core (SURVEY.md T3).

Parameters are nested dicts of jnp arrays; modules are frozen dataclasses
holding static config. This replaces the reference's torch ``nn.Module`` state
(SURVEY.md §2.1 R4) with a functional design that composes with jit / grad /
vmap / shard_map without adapters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp


def glorot(key: jax.Array, shape: tuple[int, ...], dtype=jnp.float32) -> jax.Array:
    fan_in, fan_out = shape[0], shape[-1]
    limit = jnp.sqrt(6.0 / (fan_in + fan_out))
    return jax.random.uniform(key, shape, dtype, minval=-limit, maxval=limit)


_ACTIVATIONS: dict[str, Callable[[jax.Array], jax.Array]] = {
    "relu": jax.nn.relu,
    "elu": jax.nn.elu,
    "gelu": jax.nn.gelu,
    "tanh": jnp.tanh,
    "sigmoid": jax.nn.sigmoid,
    "leaky_relu": jax.nn.leaky_relu,
    "identity": lambda x: x,
    "none": lambda x: x,
}


def parse_activation(name: str) -> Callable[[jax.Array], jax.Array]:
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; valid: {sorted(_ACTIVATIONS)}")


@dataclasses.dataclass(frozen=True)
class Dense:
    """y = act(x @ W + b)."""

    in_dim: int
    out_dim: int
    activation: str = "identity"
    use_bias: bool = True

    def init(self, key: jax.Array) -> dict:
        params = {"w": glorot(key, (self.in_dim, self.out_dim))}
        if self.use_bias:
            params["b"] = jnp.zeros((self.out_dim,), jnp.float32)
        return params

    def apply(self, params: dict, x: jax.Array) -> jax.Array:
        # f32 accumulation inside the matmul, result back in the compute dtype
        y = jnp.dot(
            x, params["w"].astype(x.dtype), preferred_element_type=jnp.float32
        )
        if self.use_bias:
            y = y + params["b"]
        return parse_activation(self.activation)(y).astype(x.dtype)


@dataclasses.dataclass(frozen=True)
class MLP:
    """Stacked Dense layers; hidden layers use ``activation``, output linear
    unless ``activate_final``."""

    dims: tuple[int, ...]  # (in, hidden..., out)
    activation: str = "relu"
    activate_final: bool = False

    def _layers(self) -> list[Dense]:
        layers = []
        for i in range(len(self.dims) - 1):
            last = i == len(self.dims) - 2
            act = self.activation if (not last or self.activate_final) else "identity"
            layers.append(Dense(self.dims[i], self.dims[i + 1], act))
        return layers

    def init(self, key: jax.Array) -> dict:
        keys = jax.random.split(key, max(len(self.dims) - 1, 1))
        return {f"layer_{i}": l.init(keys[i]) for i, l in enumerate(self._layers())}

    def apply(self, params: dict, x: jax.Array) -> jax.Array:
        for i, l in enumerate(self._layers()):
            x = l.apply(params[f"layer_{i}"], x)
        return x
