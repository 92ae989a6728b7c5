"""Candidate-pair broadphase: the port's ``grid_candidate_pairs`` and
``swept_candidate_pairs`` against the JAX package's on the same numpy
centres and radii, every output exact (pairs, valid, the candidate count,
overflow, dtypes), and against a brute-force pair set; the overflow
contract (a window or a row budget too small is reported) as
``tests/test_broadphase.py`` pins it."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gjkepa_tpu.ops import broadphase as jb
from gjkepa_tpu_torch.ops.broadphase import (grid_candidate_pairs,
                                             swept_candidate_pairs)

torch.set_num_threads(1)

# compiled once a shape: the eager rolls take seconds a call
JAX_SWEPT = jax.jit(jb.swept_candidate_pairs,
                    static_argnames=("max_pairs", "window", "inflate"))
JAX_GRID = jax.jit(jb.grid_candidate_pairs,
                   static_argnames=("cell_size", "max_pairs"))


def _spheres(n, scale, seed):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    radii = (0.3 + 0.4 * rng.random(n)).astype(np.float32)
    return centers, radii


def _grid_spheres():
    """A regular 4 x 4 x 4 lattice, spacing 0.9, radius 0.3: 16 bodies
    share each x_lo, so the order within a tie decides the pair list."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    return (g.reshape(-1, 3) * 0.9).astype(np.float32), np.full(64, 0.3,
                                                                np.float32)


def _pair_set(pairs, valid):
    p = np.asarray(pairs)[np.asarray(valid)]
    return {frozenset((int(i), int(j))) for i, j in p if i != j}


def _brute_pairs(centers, radii, inflate):
    n = len(centers)
    return {frozenset((i, j)) for i in range(n) for j in range(i + 1, n)
            if np.linalg.norm(centers[i] - centers[j])
            <= radii[i] + radii[j] + inflate}


def _equal(ref, got):
    for r, g in zip(ref, got):
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype
        np.testing.assert_array_equal(g.numpy(), r)


CASES = {                     # (n, scale, seed, max_pairs, window)
    "sparse256": (256, 4.0, 0, 8192, 128),
    "grid128": (128, 3.0, 1, 4096, 127),
    "clump_window8": (64, 0.05, 2, 4096, 8),
    "clump_rows64": (64, 0.25, 3, 64, 63),
}


@pytest.mark.parametrize("case", list(CASES) + ["lattice_ties"])
def test_swept_matches_jax(case):
    if case == "lattice_ties":
        (centers, radii), mp, win = _grid_spheres(), 1024, 63
    else:
        n, scale, seed, mp, win = CASES[case]
        centers, radii = _spheres(n, scale, seed)
    ref = JAX_SWEPT(jnp.asarray(centers), jnp.asarray(radii), max_pairs=mp,
                    window=win, inflate=0.5)
    got = swept_candidate_pairs(torch.from_numpy(centers),
                                torch.from_numpy(radii), max_pairs=mp,
                                window=win, inflate=0.5)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.int32
    _equal(ref, got)
    if case == "lattice_ties":       # the 144 lattice neighbours, no overflow
        assert int(got[2]) == 144 and not bool(got[3])


@pytest.mark.parametrize("case", list(CASES) + ["lattice_ties"])
def test_grid_matches_jax(case):
    if case == "lattice_ties":
        (centers, radii), mp = _grid_spheres(), 1024
    else:
        n, scale, seed, mp, _ = CASES[case]
        centers, radii = _spheres(n, scale, seed)
    ref = JAX_GRID(jnp.asarray(centers), jnp.asarray(radii), cell_size=0.5,
                   max_pairs=mp)
    got = grid_candidate_pairs(torch.from_numpy(centers),
                               torch.from_numpy(radii), cell_size=0.5,
                               max_pairs=mp)
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("case", ["sparse256", "lattice_ties"])
def test_swept_and_grid_equal_brute_force(case):
    """Without overflow both give the brute-force pair set and count."""
    if case == "lattice_ties":
        centers, radii = _grid_spheres()
    else:
        centers, radii = _spheres(256, 4.0, 0)
    c, r = torch.from_numpy(centers), torch.from_numpy(radii)
    want = _brute_pairs(centers, radii, 0.5)
    pairs, valid, n_cand, overflow = swept_candidate_pairs(
        c, r, max_pairs=8192, window=len(c) - 1)
    assert not bool(overflow) and int(n_cand) == len(want)
    assert _pair_set(pairs, valid) == want
    g_pairs, g_valid, g_n = grid_candidate_pairs(c, r, cell_size=0.5,
                                                 max_pairs=8192)
    assert _pair_set(g_pairs, g_valid) == want and int(g_n) == len(want)


def test_swept_reports_window_and_row_overflow():
    """A clump whose intervals reach past the window, and a pair budget
    below the candidate count, are each reported."""
    centers, radii = _spheres(64, 0.05, 2)
    c, r = torch.from_numpy(centers), torch.from_numpy(radii)
    *_, over = swept_candidate_pairs(c, r, max_pairs=4096, window=8)
    assert bool(over)
    *_, n_cand, over = swept_candidate_pairs(c, r, max_pairs=64, window=63)
    assert int(n_cand) > 64 and bool(over)
