"""The pair axis split over a list of devices.

Port of ``gjkepa_tpu/parallel/sharding.py``.  The JAX package drives a 1-D
``Mesh`` from one process through ``shard_map``; queries are independent,
so the shards exchange nothing but the contact count's ``psum``.  The port
keeps that single-controller model: one process gives each device its
slice of the pair axis and launches that slice's query on it, and the
count's partial sums are copied to the first device and added there.

  * :func:`pair_mesh` lists the devices: the CUDA cards (all, or the
    first ``n_devices``), or ``n_devices`` entries of one named device
    (``device="cpu"`` or ``"cuda:0"``), the counterpart of the JAX tests'
    virtual CPU devices;
  * :func:`shard_pairs` puts equal chunks of the leading axis on them;
  * the sharded queries return a :class:`Sharded` (each shard on its
    device); :meth:`Sharded.gather` joins it into one result.

The portable query reads a flag back on every GJK and EPA iteration, so
its shards run one after another; the fused query issues every shard's
K1 and K2 before the contact rows, which read nothing back.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import api
from ..config import DEFAULT_CONFIG, GJKEPAConfig
from ..ops.fused import fused_gjkepa_hulls

__all__ = ["PairMesh", "Sharded", "pair_mesh", "shard_pairs",
           "gjkepa_batch_sharded", "gjkepa_batch_fused_sharded",
           "contact_count_sharded"]


@dataclasses.dataclass(frozen=True)
class PairMesh:
    """A 1-D mesh over the pair axis: shard i lives on ``devices[i]``."""

    devices: list[torch.device]
    axis_names: tuple[str, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


@dataclasses.dataclass(frozen=True)
class Sharded:
    """Per-device values along the pair axis: ``shards[i]`` (a tensor or a
    result of tensors) lives on ``mesh.devices[i]``."""

    shards: list
    mesh: PairMesh

    def gather(self):
        """The shards joined along the pair axis on the mesh's first
        device: a tensor, or a result of the shards' type."""
        dev = self.mesh.devices[0]
        first = self.shards[0]
        if isinstance(first, torch.Tensor):
            return torch.cat([s.to(dev) for s in self.shards])
        return type(first)(*(torch.cat([f.to(dev) for f in fields])
                             for fields in zip(*self.shards)))


def pair_mesh(n_devices: int | None = None, axis: str = "pairs",
              device: torch.device | str | None = None) -> PairMesh:
    """1-D device mesh over the pair axis.

    Without ``device``: the CUDA cards ``cuda:0 .. n-1``, all of them or the
    first ``n_devices``; raises when there is no card (it never falls back
    to the CPU).  With ``device`` (``"cpu"``, ``"cuda:0"``): ``n_devices``
    entries (default 1) of that one device."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"pair_mesh: n_devices must be positive, got "
                         f"{n_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("pair_mesh: no CUDA device "
                               "(torch.cuda.is_available() is false); name "
                               "one with device=..., e.g. device='cpu'")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if n > count:
            raise ValueError(f"pair_mesh: {n} devices asked for, {count} "
                             "CUDA devices present")
        return PairMesh([torch.device("cuda", i) for i in range(n)], (axis,))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"pair_mesh: no CUDA device for {dev}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"pair_mesh: no {dev} "
                             f"({torch.cuda.device_count()} CUDA devices)")
    return PairMesh([dev] * (1 if n_devices is None else n_devices), (axis,))


def _check_axis(mesh: PairMesh, axis: str) -> None:
    if mesh.axis_names != (axis,):
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis_names}")


def shard_pairs(mesh: PairMesh, *tensors: torch.Tensor, axis: str = "pairs"):
    """Split each tensor's leading (pair) axis into ``mesh.size`` equal
    chunks, chunk i on ``mesh.devices[i]``: one :class:`Sharded` for one
    tensor, a tuple for several.  Raises ValueError when the batch is not
    divisible by the mesh size, as ``jax.device_put`` does."""
    _check_axis(mesh, axis)
    out = []
    for t in tensors:
        b = t.shape[0]
        if b % mesh.size:
            raise ValueError(f"shard_pairs: the pair axis ({b}) is not "
                             f"divisible by the mesh size ({mesh.size})")
        k = b // mesh.size
        out.append(Sharded([t[i * k:(i + 1) * k].to(d)
                            for i, d in enumerate(mesh.devices)], mesh))
    return out[0] if len(out) == 1 else tuple(out)


def _shards(mesh: PairMesh, x, axis: str) -> list:
    """The per-device chunks of ``x``: its shards when it is already
    sharded over ``mesh``, else :func:`shard_pairs`'s (None for None)."""
    if x is None:
        return [None] * mesh.size
    if isinstance(x, Sharded):
        if x.mesh != mesh:
            raise ValueError("the input is sharded over another mesh")
        return x.shards
    return shard_pairs(mesh, x, axis=axis).shards


def _map(mesh: PairMesh, axis: str, fn, *args) -> Sharded:
    parts = [_shards(mesh, a, axis) for a in args]
    return Sharded([fn(*xs) for xs in zip(*parts)], mesh)


def gjkepa_batch_sharded(mesh: PairMesh, p1, p2, mask1=None, mask2=None,
                         cfg: GJKEPAConfig = DEFAULT_CONFIG,
                         axis: str = "pairs") -> Sharded:
    """The portable batch query (:func:`api.gjkepa_batch`) on each shard
    on its device.  Inputs are tensors or :class:`Sharded` tensors over
    ``mesh``; the result's shards are :class:`CollisionResult`."""
    _check_axis(mesh, axis)
    return _map(mesh, axis, lambda a, b, m1, m2: api.gjkepa_batch(
        a, b, m1, m2, cfg=cfg), p1, p2, mask1, mask2)


def gjkepa_batch_fused_sharded(mesh: PairMesh, p1, p2, mask1=None,
                               mask2=None, cfg: GJKEPAConfig | None = None,
                               axis: str = "pairs") -> Sharded:
    """The fused hull query on each shard on its device: K1, then K2 over
    the hits (:func:`fused_gjkepa_hulls`), then the contact rows
    (:func:`api.derive_contact_batch`).  Every shard's kernels are issued
    before any shard's contact rows, as the JAX package runs the kernels
    under ``shard_map`` and the contact rows after."""
    _check_axis(mesh, axis)
    if cfg is None:
        cfg = GJKEPAConfig.for_f32()
    parts = list(zip(*(_shards(mesh, x, axis)
                       for x in (p1, p2, mask1, mask2))))
    fused = [fused_gjkepa_hulls(*xs, cfg=cfg) for xs in parts]
    return Sharded([api.derive_contact_batch(a, b, r, cfg, m1, m2)
                    for (a, b, m1, m2), r in zip(parts, fused)], mesh)


def contact_count_sharded(mesh: PairMesh, p1, p2,
                          cfg: GJKEPAConfig = DEFAULT_CONFIG,
                          axis: str = "pairs") -> torch.Tensor:
    """Global hit count over a sharded pair batch: the portable query's
    ``hit.sum()`` as int32 on each shard's device, the partial sums copied
    to ``mesh.devices[0]`` and added there (the JAX package's ``psum``).
    A 0-d tensor on that device; the host reads it when the caller does."""
    _check_axis(mesh, axis)
    partial = _map(mesh, axis, lambda a, b: api.gjkepa_batch(
        a, b, cfg=cfg).hit.sum(dtype=torch.int32), p1, p2)
    home = mesh.devices[0]
    return torch.stack([c.to(home) for c in partial.shards]).sum(
        dtype=torch.int32)

