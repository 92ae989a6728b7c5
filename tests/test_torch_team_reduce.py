"""The team and warp reductions of the port's kernels, modelled in torch.

K1 (csrc/gjk_hulls.cu) and K9 (csrc/gjk_hull_shape.cu) scan a pair's
hulls with a team of 4-32 threads, K10 with a warp, K12 with a warp and
K13 with a block of warps, all reducing (dot, vertex)
pairs under one total order (csrc/hull_stream.cuh); K13's EPA tier
(csrc/epa_warp.cuh) splits its face scans across a warp with a
(distance, face) reduction and ballot/prefix ranks; K8
(csrc/distance_hulls.cu) deals its 15 distance candidates out over a team
and reduces (key, d2) pairs.  The CUDA code runs only on the card; these
tests hold its rules, as ``fused_streamed.warp_first_max_plain``,
``warp_first_min_plain``, ``ballot_rank_plain`` and
``fused_distance.team_closest_plain`` model them, to the torch operations
the plain EPA phase (``fused_epa.epa_phase``), the plain support and the
plain distance GJK use: ``argmax``, ``argmin``, the stable ``argsort``,
``cumsum`` and the in-order fold with strict <.  All exact.
"""

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_distance as fd
from gjkepa_tpu_torch.ops import fused_gjk
from gjkepa_tpu_torch.ops import fused_hull_shapes as fh
from gjkepa_tpu_torch.ops.fused import mask_to_padding
from gjkepa_tpu_torch.ops import fused_streamed as fst
from gjkepa_tpu_torch.ops.fused_epa import BIG

WIDTHS = (4, 8, 16, 32)


def _tie_dots(case, width):
    """(B, N) dots whose first maximum falls on a tie: in one thread's
    columns (i and i + width), across threads (i and i + 1), on a grid of
    few values, all equal, or with fewer columns than threads."""
    rng = np.random.default_rng(width)
    if case == "all_equal":
        return np.full((4, 3 * width + 5), 0.25, np.float32)
    if case == "short":                 # n < width: threads that own nothing
        d = rng.integers(-3, 3, size=(64, width - 1)).astype(np.float32)
        d[:, width // 2] = d[:, 1] = 5.0
        return d
    d = rng.integers(-20, 20, size=(64, 7 * width)).astype(np.float32)
    if case == "same_thread":
        d[:, [2 + 3 * width, 2, 2 + width]] = 30.0
    elif case == "other_threads":
        d[:, [width + 2, width + 1, 6 * width]] = 30.0
    elif case == "grid":
        d = rng.integers(-2, 3, size=(64, 5 * width + 3)).astype(np.float32)
    return d


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", ["all_equal", "short", "same_thread",
                                  "other_threads", "grid"])
def test_team_first_max_is_the_first_maximum(case, width):
    """K11's reduction at every team width K1 may take: torch.argmax."""
    dots = torch.from_numpy(_tie_dots(case, width))
    got = fst.warp_first_max_plain(dots, width)
    assert torch.equal(got, torch.argmax(dots, dim=1))
    want = {"same_thread": 2, "other_threads": width + 1, "short": 1}
    if case in want:
        assert bool((got == want[case]).all())


def test_team_sizes_are_the_kernels():
    """K1's team sizes divide the warp, and the rule takes the measured
    crossovers (4 up to 64 vertices, 8 up to 256, 16 up to 512, then 32)
    from the larger hull."""
    assert all(32 % t == 0 for t in fused_gjk.TEAMS)
    want = {1: 4, 24: 4, 64: 4, 65: 8, 128: 8, 256: 8, 257: 16, 512: 16,
            513: 32, 2048: 32, 8192: 32}
    for n, t in want.items():
        assert fused_gjk.team_size(n, 1) == fused_gjk.team_size(1, n) == t


def test_k9_team_rule_is_k1s_crossovers():
    """K9's team for a hull of N = 1..2048 vertices: K1's crossovers (4 up
    to 64 vertices, 8 up to 256, 16 up to 512, then 32), each a team that
    divides the warp."""
    for n in range(1, 2049):
        want = 4 if n <= 64 else 8 if n <= 256 else 16 if n <= 512 else 32
        assert fh.team_size(n) == want, n
        assert 32 % fh.team_size(n) == 0


def _padded_hull_dots(n, seed):
    """(B, N) dots of hulls padded through a mask (20% of the rows out,
    each replaced by the hull's first valid vertex, as ``mask1`` does),
    along random directions, computed as the kernels compute them."""
    rng = np.random.default_rng(seed)
    hulls = torch.from_numpy(fixtures.random_hulls(rng, 64, n))
    keep = torch.from_numpy(rng.random((64, n)) > 0.2)
    keep[:, 0] = False                  # the copied vertex is not vertex 0
    keep[:, 1] = True
    p = mask_to_padding(hulls, keep)
    d = torch.from_numpy(rng.normal(size=(64, 64, 3)).astype(np.float32))
    dots = (p[:, None, :, 0] * d[:, :, None, 0]
            + p[:, None, :, 1] * d[:, :, None, 1]
            + p[:, None, :, 2] * d[:, :, None, 2])
    return dots.reshape(-1, n)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", [21, 22, 23, 24, 63, 64])
def test_team_first_max_on_padded_hulls(n, width):
    """K9's and K10's hull scan (TeamHullShapeSupport) at every team width
    on hulls padded by a repeated vertex, whose copies tie exactly, and at
    N % 4 != 0: the first maximum, torch.argmax, read by single vertices
    and, where N % 4 == 0, by the kernels' 4-vertex groups."""
    dots = _padded_hull_dots(n, 100 + n)
    top = dots.max(dim=1, keepdim=True).values
    assert int(((dots == top).sum(dim=1) > 1).sum()) > 50    # tied maxima
    want = torch.argmax(dots, dim=1)
    for group in (1, 4) if n % 4 == 0 else (1,):
        assert torch.equal(fst.warp_first_max_plain(dots, width, group), want)


def _face_states(f, seed):
    """(B, F) face distances as the EPA phase sees them: alive faces with
    ties on a coarse grid, degenerate planes (BIG), dead faces (BIG)."""
    rng = np.random.default_rng(seed)
    b = 256
    d = rng.integers(0, 6, size=(b, f)).astype(np.float32) * 0.125
    alive = rng.random((b, f)) < 0.7
    alive[: b // 8] = False                         # every face dead
    d[rng.random((b, f)) < 0.1] = BIG                 # degenerate planes
    d[b // 8: b // 4] = BIG                           # every plane degenerate
    return torch.from_numpy(np.where(alive, d, np.float32(BIG)))


@pytest.mark.parametrize("f", [4, 8, 16, 31, 48, 88, 208])
def test_warp_first_min_is_the_plain_argmin(f):
    """epa_warp.cuh's min face: fused_epa.epa_phase's torch.argmin, the
    first minimum, index 0 when every face is dead or degenerate."""
    dvals = _face_states(f, f)
    got = fst.warp_first_min_plain(dvals)
    assert torch.equal(got, torch.argmin(dvals, dim=1))
    assert bool((got[:64] == 0).all())


@pytest.mark.parametrize("f,k", [(8, 2), (48, 8), (88, 8), (208, 16), (33, 4)])
def test_ballot_compaction_is_the_stable_argsort(f, k):
    """The visible faces' ballot ranks: the first K are epa_phase's
    ``argsort((~visible).int8, stable=True)[:, :K]`` (valid below nvis),
    and the count is ``visible.sum()``."""
    rng = np.random.default_rng(f * 100 + k)
    visible = torch.from_numpy(rng.random((256, f)) < rng.random((256, 1)))
    rank, nvis = fst.ballot_rank_plain(visible)
    assert torch.equal(nvis, visible.sum(dim=1))
    src = torch.argsort((~visible).to(torch.int8), dim=1, stable=True)[:, :k]
    for lane in range(visible.shape[0]):
        faces = torch.nonzero(visible[lane])[:, 0]
        assert torch.equal(rank[lane, faces], torch.arange(len(faces)))
        n = min(k, len(faces))
        assert torch.equal(faces[:n], src[lane, :n])
    assert bool((rank[~visible] == -1).all())


@pytest.mark.parametrize("f", [8, 48, 88, 208])
def test_ballot_free_rank_is_the_cumsum(f):
    """The free faces' ballot ranks (dead or visible): epa_phase's
    ``rank_f = cumsum(free) - 1`` on every free face, and the horizon rows'
    ballot order is its ``hord`` (stable argsort of the horizon)."""
    rng = np.random.default_rng(f)
    free = torch.from_numpy(rng.random((256, f)) < 0.4)
    rank, n_free = fst.ballot_rank_plain(free)
    rank_f = torch.cumsum(free.to(torch.int32), dim=1) - 1
    assert torch.equal(rank[free], rank_f[free].long())
    assert torch.equal(n_free, free.sum(dim=1))
    for k in (2, 8, 16):                       # 3K edge rows, e-major
        horizon = torch.from_numpy(rng.random((256, 3 * k)) < 0.5)
        hrank, n_new = fst.ballot_rank_plain(horizon)
        hord = torch.argsort((~horizon).to(torch.int8), dim=1, stable=True)
        for lane in range(0, 256, 17):
            rows = torch.nonzero(horizon[lane])[:, 0]
            assert torch.equal(hord[lane, :int(n_new[lane])], rows)
            assert torch.equal(hrank[lane, rows], torch.arange(len(rows)))


BLOCK_WARPS = (1, 2, 4, 8, 16)


@pytest.mark.parametrize("warps", BLOCK_WARPS)
@pytest.mark.parametrize("case", ["all_equal", "short", "same_thread",
                                  "other_threads", "grid", "other_warps"])
def test_block_first_max_is_the_first_maximum(case, warps):
    """K12's and K13's block-wide reduction (csrc/hull_stream.cuh
    BlockHullSupport): each warp's first maximum, folded in warp order,
    is torch.argmax, with ties within one thread, across the threads of a
    warp and across warps."""
    width = 32 * warps
    if case == "other_warps":   # equal maxima in warps 2, 1, 0 of a later row
        rng = np.random.default_rng(warps)
        d = rng.integers(-20, 20, size=(64, 3 * width + 7)).astype(np.float32)
        cols = [width + 32 * min(u, warps - 1) + lane
                for u, lane in ((2, 5), (1, 3), (0, 7))] + [3 * width + 1]
        d[:, cols] = 30.0
        want = min(cols)
    else:
        d, want = _tie_dots(case, width), None
    dots = torch.from_numpy(d)
    got = fst.block_first_max_plain(dots, warps)
    assert torch.equal(got, torch.argmax(dots, dim=1))
    if want is not None:
        assert bool((got == want).all())


def _in_order_first_min(d2):
    """The plain distance GJK's fold (fused_distance._distance_lanes): from
    candidate 0, a later candidate replaces the best on a strict <."""
    best, k = d2[:, 0], torch.zeros(d2.shape[0], dtype=torch.int64)
    for j in range(1, d2.shape[1]):
        better = d2[:, j] < best
        best = torch.where(better, d2[:, j], best)
        k = torch.where(better, j, k)
    return k


def _candidate_d2(case):
    """(L, 15) candidate distances: ties on a coarse grid, invalid ones
    (BIG) up to whole rows, all equal, NaNs (candidate 0's included), and
    +0 against -0."""
    rng = np.random.default_rng(len(case))
    d = rng.integers(0, 4, size=(512, 15)).astype(np.float32) * 0.5
    if case == "big":
        d[rng.random(d.shape) < 0.6] = fd.BIG
        d[:64] = fd.BIG
    elif case == "equal":
        d[:] = 0.75
    elif case == "nan":
        d[rng.random(d.shape) < 0.2] = np.nan
        d[:32, 0] = np.nan
        d[32:64, 1:] = np.nan
    elif case == "signed_zero":
        d = np.where(rng.random(d.shape) < 0.5, np.float32(0.0),
                     np.float32(-0.0)).astype(np.float32)
        d[:, 14] = fd.BIG
    return torch.from_numpy(d)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("case", ["grid", "big", "equal", "nan",
                                  "signed_zero"])
def test_team_closest_is_the_in_order_first_minimum(case, width):
    """K8's dealt candidates and (key, d2) shuffles at every team width:
    the plain version's in-order fold with strict <, on ties, invalid
    candidates, NaNs (a NaN candidate 0 is kept, a later NaN never taken)
    and signed zeros."""
    d2 = _candidate_d2(case)
    got = fd.team_closest_plain(d2, width)
    assert torch.equal(got, _in_order_first_min(d2))
    if case == "equal":
        assert bool((got == 0).all())
    if case == "nan":
        assert bool((got[:32] == 0).all()) and bool((got[32:64] == 0).all())


def test_deal_is_a_permutation_of_the_candidates():
    """K8's deal covers each of the 15 candidates once, runs of 4 slots of
    one kind (vertices, edges, faces) first."""
    assert sorted(fd.DEAL) == list(range(15))
    kind = [0] * 4 + [1] * 6 + [2] * 4 + [3]
    assert [kind[k] for k in fd.DEAL[:12]] == [0] * 4 + [1] * 4 + [2] * 4
