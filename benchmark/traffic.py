"""The one generator of the benchmark's inputs.

A traffic file (``benchmark/traffic/<name>.json``) gives, for each side of
a pair, how its hulls are drawn; a configuration file gives the pair count,
the vertices a hull and the pool size.  Every hull is a cloud of points on
the unit sphere, each scaled by U(0.5, 1), the cloud scaled by ``scale``
and moved by N(0, ``offset_sd``^2) in each coordinate: the recipe of the
repository's ``random_hulls`` (``spread`` is ``offset_sd`` at scale 1) and,
with a big hull around a small offset one, of its deep pairs.

The pool is drawn on the device from ``--seed`` with one generator, batch
by batch and side by side, in float32, the type the query serves.
"""

from __future__ import annotations

import torch

SEED_MODULUS = 2 ** 63


def draw_side(gen: torch.Generator, pairs: int, vertices: int, scale: float,
              offset_sd: float, device) -> torch.Tensor:
    """(pairs, vertices, 3) float32 hulls of one side."""
    v = torch.randn(pairs, vertices, 3, generator=gen, device=device)
    v = v / v.norm(dim=-1, keepdim=True)
    r = torch.rand(pairs, vertices, 1, generator=gen, device=device)
    off = torch.randn(pairs, 1, 3, generator=gen, device=device)
    return v * ((0.5 + 0.5 * r) * scale) + off * offset_sd


def make_pool(config: dict, traffic: dict, seed: int, device,
              pairs: int | None = None, pool: int | None = None):
    """The cell's pool of distinct batches: a list of (p1, p2).  ``pairs``
    and ``pool`` replace the configuration's sizes (small runs on the CPU
    only)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % SEED_MODULUS)
    pairs = config["pairs"] if pairs is None else pairs
    pool = config["pool"] if pool is None else pool
    out = []
    for _ in range(pool):
        out.append(tuple(
            draw_side(gen, pairs, n, side["scale"], side["offset_sd"], device)
            for n, side in zip(config["vertices"], traffic["sides"])))
    return out
