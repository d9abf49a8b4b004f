"""Carry the JAX package's parameter pytrees (nested dicts and lists of
arrays, given as numpy) into the port's modules.

The port's module paths are the JAX pytree paths joined with dots, and its
layouts are the JAX ones, so the conversion is a flatten with no transposes:
``params["input"][0][0]["in_conv"]["kernel"]`` -> ``input.0.0.in_conv.kernel``.
The key sets must match exactly.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def flatten_pytree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict/list pytree -> {dotted path: numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten_pytree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_from_jax(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a JAX parameter pytree into ``module`` (same paths, same shapes;
    values cast to each parameter's dtype and device). Returns the module."""
    flat = flatten_pytree(params)
    own = module.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"parameter paths differ: missing {missing[:8]}, unexpected {extra[:8]}")
    with torch.no_grad():
        for name, dst in own.items():
            src = flat[name]
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{name}: shape {src.shape} != {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, dtype=np.float32)))
    return module
