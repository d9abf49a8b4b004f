"""Device mesh and the height-split activation, counterpart of
``cgd_tpu/parallel/mesh.py``.

The axes are the JAX package's: ``data`` splits the sample batch, ``cut``
splits the UNet's activations by image height (and, with ``data``, the
cutout batch that CLIP encodes). As in the JAX package, one process drives
every device of the mesh: a shard moves to its neighbour with ``.to(device)``
and autograd carries the gradient back the same way. A mesh built from an
explicit device list may name one device more than once, the counterpart of
``--xla_force_host_platform_device_count``: shards that share a device run
one after the other (``make_mesh([cuda0, cuda0])`` is a ``cut=2`` mesh on one
card, ``make_mesh([cpu, cpu])`` one on the CPU).

``Split`` is the height-split activation: per-shard NHWC tensors, batch over
``data`` and rows top to bottom over ``cut``, in shards of equal height. The
ops of ``cgd_tpu_torch.ops.nn`` and the UNet take it wherever they take a
tensor. A UNet level whose height the ``cut`` axis does not divide (``cut=4``
below a 24px image's 12^2 level, ``cut=3`` at any power-of-two size) runs
whole on the mesh's first device: the downsample into it gathers the
activation, and the skip connection on the way up splits it again. The JAX
package pads such a level's last shards under GSPMD instead; both compute
the same values (tests/test_torch_port_mesh.py holds the two together).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch


def _norm(dev) -> torch.device:
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """``data x cut`` devices in the JAX axis order; ``devices`` is a numpy
    object array of ``torch.device`` shaped [data, cut]."""

    axis_names = ("data", "cut")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        # id(parameter) -> (parameter, {device: its replica there})
        self._replicas: Dict[int, tuple] = {}

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def main(self) -> torch.device:
        """Where the run's unsplit tensors live: the first device."""
        return self.devices[0, 0]

    def distinct_devices(self) -> List[torch.device]:
        return list(dict.fromkeys(self.devices.flat))

    def place(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        """``t`` on ``dev``: itself, its replica there, or a copy."""
        if t.device == dev:
            return t
        rep = self._replicas.get(id(t))
        if rep is not None and dev in rep[1]:
            return rep[1][dev]
        return t.to(dev)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={list(self.devices.flat)})"


def visible_devices(kind: str = "cuda") -> List[torch.device]:
    """Every visible CUDA card, or the one CPU device for ``kind="cpu"``."""
    if torch.device(kind).type == "cpu":
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(devices: Optional[Sequence] = None, data: int = 1) -> Mesh:
    """('data', 'cut') mesh over the given (default: every visible card)
    devices; ``data`` of them split the batch, the rest the height. A
    device may repeat."""
    devices = [_norm(d) for d in (devices if devices is not None else visible_devices())]
    n = len(devices)
    if n == 0 or n % data:
        raise ValueError(f"make_mesh: {n} devices do not split into data={data} rows")
    arr = np.empty((data, n // data), dtype=object)
    for i, d in enumerate(devices):
        arr.flat[i] = d
    return Mesh(arr)


def mesh_from_spec(spec: Optional[str], devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """Build a mesh from the ``--mesh`` spec string, over ``devices``
    (default: every visible card). The grammar and errors of
    ``cgd_tpu.parallel.mesh.mesh_from_spec``:

      None / ""        -> None (single-device run)
      "auto"           -> all devices, data=1; None if only one device
      "data=N"         -> N-way batch split; the rest of the devices split
                          the height and the cutouts
      "cut=M"          -> data=1 over the first M devices
      "data=N,cut=M"   -> explicit axis sizes over the first N*M devices
    """
    if not spec:
        return None
    devices = list(devices if devices is not None else visible_devices())
    if spec == "auto":
        return make_mesh(devices, data=1) if len(devices) > 1 else None
    sizes = {}
    for part in spec.split(","):
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key not in ("data", "cut") or not val.isdigit() or int(val) < 1:
            raise ValueError(
                f"bad --mesh spec {spec!r}: expected 'auto', 'data=N', "
                "'cut=M', or 'data=N,cut=M'"
            )
        sizes[key] = int(val)
    data = sizes.get("data", 1)
    if "cut" in sizes:
        need = data * sizes["cut"]
        if need > len(devices):
            raise ValueError(
                f"--mesh {spec!r} needs {need} devices but only "
                f"{len(devices)} are visible"
            )
        devices = devices[:need]
    elif len(devices) % data != 0:
        raise ValueError(
            f"--mesh {spec!r}: device count {len(devices)} is not divisible "
            f"by data={data}"
        )
    return make_mesh(devices, data=data)


def shard_params_replicated(module: torch.nn.Module,
                            mesh: Mesh) -> Dict[torch.device, torch.nn.Module]:
    """The module on every distinct device of the mesh: itself on its own
    device, a copy on each other one. ``mesh.place`` then finds a
    parameter's copy by the original."""
    home = next(module.parameters()).device
    out = {}
    for dev in mesh.distinct_devices():
        if dev == home:
            out[dev] = module
            continue
        rep = copy.deepcopy(module).to(dev)
        for p, q in zip(module.parameters(), rep.parameters()):
            mesh._replicas.setdefault(id(p), (p, {}))[1][dev] = q
        out[dev] = rep
    return out


class Split:
    """An NHWC activation split over a mesh: ``shards[d][c]`` holds batch
    rows ``d`` of ``data`` and image rows ``c`` of ``cut`` (top to bottom)
    and lies on ``mesh.devices[d, c]``."""

    def __init__(self, shards: List[List[torch.Tensor]], mesh: Mesh):
        self.shards = shards
        self.mesh = mesh

    @property
    def shape(self):
        b = sum(row[0].shape[0] for row in self.shards)
        h = sum(t.shape[1] for t in self.shards[0])
        return (b, h, *self.shards[0][0].shape[2:])

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0][0].dtype

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Split":
        return Split([[fn(t) for t in row] for row in self.shards], self.mesh)

    def zip_map(self, other: "Split", fn) -> "Split":
        return Split([[fn(a, b) for a, b in zip(ra, rb)]
                      for ra, rb in zip(self.shards, other.shards)], self.mesh)

    def to(self, dtype: torch.dtype) -> "Split":
        return self.map(lambda t: t.to(dtype))

    def float(self) -> "Split":
        return self.to(torch.float32)

    def rows(self, t: torch.Tensor, d: int) -> torch.Tensor:
        """Data group ``d``'s batch rows of an unsplit per-sample tensor (a
        batch of 1 broadcasts)."""
        if t.shape[0] == 1:
            return t
        return t.chunk(len(self.shards))[d]

    def map_rows(self, fn, *per_sample: torch.Tensor) -> "Split":
        """``fn(shard, *rows)`` with each unsplit per-sample tensor's rows of
        the shard's data group on the shard's device."""
        place = self.mesh.place
        return Split([[fn(t, *(place(self.rows(u, d), t.device) for u in per_sample))
                       for t in row] for d, row in enumerate(self.shards)], self.mesh)

    def __add__(self, other) -> "Split":
        if isinstance(other, Split):
            return self.zip_map(other, lambda a, b: a + b)
        return self.map_rows(lambda t, u: t + u, other)

    def gathered(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        """Apply ``fn`` to each data group whole (its shards concatenated on
        H on the group's first device) and split the result back into equal
        heights (``fn`` may change the height, as a stride-2 conv does): the
        attention's all-gather. A result whose height the shards do not
        divide comes back whole, on the mesh's first device (the module
        docstring)."""
        wholes = [fn(torch.cat([t.to(row[0].device) for t in row], dim=1)) for row in self.shards]
        cut = len(self.shards[0])
        if wholes[0].shape[1] % cut:
            return torch.cat([w.to(self.mesh.main) for w in wholes], dim=0)
        return Split([[p.to(t.device) for p, t in zip(w.chunk(cut, dim=1), row)]
                      for w, row in zip(wholes, self.shards)], self.mesh)

    def gather(self) -> torch.Tensor:
        """The whole tensor on the mesh's first device."""
        main = self.mesh.main
        return torch.cat([torch.cat([t.to(main) for t in row], dim=1) for row in self.shards],
                         dim=0)


def split_activation(x: torch.Tensor, mesh: Mesh) -> Split:
    """Split NHWC ``x`` over the mesh: batch over 'data', height over 'cut'
    (both must divide evenly)."""
    data, cut = mesh.devices.shape
    b, h = x.shape[0], x.shape[1]
    if b % data or h % cut:
        raise ValueError(f"split_activation: batch {b} / height {h} do not divide over "
                         f"data={data} / cut={cut}")
    return Split([[p.to(mesh.devices[d, c]) for c, p in enumerate(xb.chunk(cut, dim=1))]
                  for d, xb in enumerate(x.chunk(data, dim=0))], mesh)
