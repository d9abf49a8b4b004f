"""The converted-checkpoint format of ``cgd_tpu/utils/pytree_io.py``: a flat
``.npz`` keyed by the parameter tree's paths joined with '/'. The port's
module paths are the same paths joined with '.', so the port reads and
writes the JAX package's ``<name>.pt.npz.cgd`` caches as they are: a cache
written by either package loads in the other
(tests/test_torch_port_checkpoints.py).
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_flat(path: str, flat: Dict[str, np.ndarray]) -> None:
    """Write a {dotted module path: array} dict (a port state dict as numpy)
    as the JAX package's flat npz."""
    # through an open handle: np.savez(str_path) appends ".npz" to a name
    # that does not end with it
    with open(path, "wb") as f:
        np.savez(f, **{k.replace(".", "/"): np.asarray(v) for k, v in flat.items()})


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Read a flat npz written by either package as {dotted path: array}."""
    with np.load(path) as data:
        return {k.replace("/", "."): data[k] for k in data.files}
