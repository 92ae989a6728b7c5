"""K6a's quad GJK iteration and its grid, modelled in torch.

K6a (csrc/gjk_shapes.cu over csrc/gjk_quad.cuh) runs a pair's GJK phase on
a quad of threads: lane f owns face f, the four scores meet by shuffles in
a strict-> chain in face order, the containment test splits one face a
lane with any/all votes, the stall test is an all vote, and each lane
keeps the raw face normal and the simplex mean of the containment test
for the next iteration's face choice; flat_tri and coplanar4 come from
lane 2's face.  The CUDA code runs only on the card; these tests hold a lane-by-lane transliteration of the quad to the
plain version (``fused_gjk.gjk_phase``) with ``torch.equal`` on c3's GJK
lanes and on degenerate inputs (coincident, collinear and coplanar
vertices, 1e-20 and 1e20 scales, NaN and infinite coordinates, grid points
that stall), and check the identities its reuse rests on, the cover
of K6a's grid, and K6b's block deal (each block's GJK lanes listed once,
in pair order, and each run by one quad).
"""

import zlib

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch import GJKEPAConfig, ShapeBatch
from gjkepa_tpu_torch.models import fixtures
from gjkepa_tpu_torch.ops import fused_shapes as fs
from gjkepa_tpu_torch.ops import shape_geom
from gjkepa_tpu_torch.ops.fused_gjk import gjk_phase, make_hull_support
from gjkepa_tpu_torch.ops.lane_geom import (FACE_IDX, P3, dist_pf_sign,
                                            is_inside_tri, pcoincide, pcross,
                                            pdot, pmean4, pnorm, pscale,
                                            putz, pwhere, pzero_like, uninml)
from gjkepa_tpu_torch.types import Status

CFG = GJKEPAConfig.for_f32()
RUNNING = -1


# -- the quad iteration, lane by lane ---------------------------------------

def lane_face(s, m, f, eps, epz):
    """Lane f's share of the containment test of simplex ``s`` (mean
    ``m``): its face's cross, norm, reciprocal and raw utz normal, and its
    on-face and positive-side votes (quad_contains)."""
    zero = pzero_like(m.x)
    a, b, c = (s[i] for i in FACE_IDX[f])
    cr = pcross(a - b, b - c)
    n = pnorm(cr)
    r = 1.0 / n
    raw = pscale(cr, torch.where(n < epz, 0.0, r))
    v = s[f]
    nml = pwhere(pdot(raw, v - m) < 0.0, -raw, raw)
    dist = pdot(v - zero, nml)
    on = (torch.abs(dist) < eps) & is_inside_tri(a, b, c, zero, epz)
    return {"cr": cr, "n": n, "r": r, "raw": raw, "on": on, "pos": dist > 0.0}


def quad_contains(s, m, eps, epz):
    faces = [lane_face(s, m, f, eps, epz) for f in range(4)]
    any_on = faces[0]["on"] | faces[1]["on"] | faces[2]["on"] | faces[3]["on"]
    all_pos = (faces[0]["pos"] & faces[1]["pos"] & faces[2]["pos"]
               & faces[3]["pos"])
    return any_on | all_pos, faces


def _pick(k, items):
    """items[k] per pair (a shuffle from lane k)."""
    out = items[0]
    for i in (1, 2, 3):
        out = pwhere(k == i, items[i], out)
    return out


def quad_gjk_phase(support, active, cfg):
    """gjk_phase_quad (csrc/gjk_quad.cuh) over (B,) pairs: the shared init
    (gjk_phase without iterations), then the split iteration."""
    eps, epz = cfg.eps_coincide, cfg.eps_zero
    s, status, it, sep = gjk_phase(support, active,
                                   cfg.replace(gjk_max_iters=0))
    s = list(s)
    # the init decides no MISS_GJK: at 0 iterations it marks the lanes the
    # iterations take (the clamped separation folds on alike)
    status = torch.where(status == Status.MISS_GJK, RUNNING, status)
    m = pmean4(s)
    in_tetra, faces = quad_contains(s, m, eps, epz)
    assert not bool((in_tetra & (status == RUNNING)).any())
    zero = pzero_like(m.x)
    l1, l2 = [zero] * 4, [zero] * 4
    while True:
        run = (status == RUNNING) & (it < cfg.gjk_max_iters)
        if not bool(run.any()):
            break
        nrm, score = [], []
        for f in range(4):                    # lane f: orient and score
            a = s[FACE_IDX[f][0]]
            raw = faces[f]["raw"]
            n = pwhere(pdot(raw, a - m) < 0.0, -raw, raw)
            nrm.append(n)
            score.append(-pdot(n, a))
        best, k = score[0], torch.zeros_like(it)
        for j in (1, 2, 3):                   # every lane: the strict-> chain
            better = score[j] > best
            best = torch.where(better, score[j], best)
            k = torch.where(better, j, k)
        d = _pick(k, nrm)
        w = support(d)
        sep = torch.where(run, torch.maximum(sep, -pdot(w, d)), sep)
        ns = [_pick(k, [s[FACE_IDX[i][slot]] for i in range(4)])
              for slot in range(3)] + [w]
        mn = pmean4(ns)
        contains, new_faces = quad_contains(ns, mn, eps, epz)
        f2 = new_faces[2]                     # lane 2: flat_tri, coplanar4
        ok = ((torch.abs(f2["cr"].x) > epz) | (torch.abs(f2["cr"].y) > epz)
              | (torch.abs(f2["cr"].z) > epz))
        unit = pscale(f2["cr"], torch.where(ok, f2["r"], 0.0))
        flat = f2["n"] < eps
        cop = torch.abs(pdot(ns[3] - ns[0], unit)) < eps
        stalled = None                        # lane f: vertex f, an all vote
        for f in range(4):
            rep = pcoincide(ns[f], l1[f], eps) | pcoincide(ns[f], l2[f], eps)
            stalled = rep if stalled is None else stalled & rep
        for cond, code in ((stalled, Status.MISS_GJK), (contains, Status.HIT),
                           (cop, Status.MISS_GJK), (flat, Status.MISS_GJK)):
            status = torch.where(run & cond, code, status)
        l2 = [pwhere(run, l1[f], l2[f]) for f in range(4)]
        l1 = [pwhere(run, s[f], l1[f]) for f in range(4)]
        s = [pwhere(run, ns[f], s[f]) for f in range(4)]
        faces = [{key: (pwhere(run, nf[key], of[key]) if isinstance(
            nf[key], P3) else torch.where(run, nf[key], of[key]))
            for key in nf} for nf, of in zip(new_faces, faces)]
        m = pwhere(run, mn, m)
        it = torch.where(run, it + 1, it)
    status = torch.where(status == RUNNING, Status.MISS_GJK,
                         status).to(torch.int32)
    hit = status == Status.HIT
    sep = torch.where(hit | ~active, 0.0, torch.clamp(sep, min=0.0))
    return tuple(s), status, it, sep


def same(x, y) -> bool:
    """torch.equal, with NaN equal to NaN."""
    if not x.is_floating_point():
        return torch.equal(x, y)
    nx, ny = torch.isnan(x), torch.isnan(y)
    return torch.equal(nx, ny) and torch.equal(torch.where(nx, 0.0, x),
                                               torch.where(ny, 0.0, y))


def _same_phase(support, active, cfg=CFG):
    want = gjk_phase(support, active, cfg)
    got = quad_gjk_phase(support, active, cfg)
    for x, y in zip(got[0], want[0]):
        assert all(same(cx, cy) for cx, cy in zip(x, y))
    for x, y in zip(got[1:], want[1:]):
        assert same(x, y)
    return want


def _c3_gjk_lanes():
    """c3's GJK lanes (fixtures.c3_pairs(0)): K5's act, as K6a gets them."""
    a, b = (ShapeBatch.from_numpy(*p, device="cpu")
            for p in fixtures.c3_pairs(0))
    sa, sb = a.packed(), b.packed()
    retired, _ = fs.retirement(a, b)
    act = fs.cf_shapes_plain(sa, sb, retired, CFG).act
    lanes = torch.nonzero(act).flatten()
    A, B = shape_geom.shape_of(sa[lanes]), shape_geom.shape_of(sb[lanes])
    return A, B, lanes


def test_quad_iteration_matches_gjk_phase_on_c3():
    """c3's 793 GJK lanes (all cylinder pairs), bit for bit."""
    A, B, lanes = _c3_gjk_lanes()
    assert lanes.numel() == 793
    assert bool(((A.kind == 3) & (B.kind == 3)).all())
    active = torch.ones(lanes.numel(), dtype=torch.bool)
    _, status, it, _ = _same_phase(
        shape_geom.make_shape_support(A, B), active)
    assert int(it.max()) == 15 and int((status == Status.HIT).sum()) == 554


def test_quad_iteration_matches_gjk_phase_on_dense_cylinders():
    rng = np.random.default_rng(3)
    a, b = (ShapeBatch.from_numpy(*fixtures.kind_batch(3, 2048, rng, 0.2),
                                  device="cpu") for _ in range(2))
    A, B = shape_geom.shape_of(a.packed()), shape_geom.shape_of(b.packed())
    _, _, it, _ = _same_phase(shape_geom.make_shape_support(A, B),
                              torch.ones(2048, dtype=torch.bool))
    assert int(it.max()) > 3


def _degenerate_hulls(case):
    """(B, 8, 3) hull pairs whose simplices degenerate."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    b, n = 256, 8
    p1 = rng.normal(size=(b, n, 3))
    p2 = rng.normal(size=(b, n, 3)) * 0.5 + rng.normal(size=(b, 1, 3)) * 0.5
    if case == "coincident":
        p1[:, 1:] = p1[:, :1]
        p2[: b // 2, 1:] = p2[: b // 2, :1]
    elif case == "collinear":
        t = rng.normal(size=(b, n, 1))
        p1 = t * rng.normal(size=(b, 1, 3)) + rng.normal(size=(b, 1, 3)) * 0.1
    elif case == "coplanar":
        p1[:, :, 2] = 0.0
        p2[: b // 2, :, 2] = 0.25 * rng.integers(-1, 2, size=(b // 2, 1))
    elif case == "tiny":
        p1, p2 = p1 * 1e-20, p2 * 1e-20
    elif case == "huge":
        p1, p2 = p1 * 1e20, p2 * 1e20
    elif case == "nan":
        p1[::3, 2, 0] = np.nan
        p2[1::5, 0, 1] = np.nan
    elif case == "inf":
        p1[::3, 1, 2] = np.inf
        p2[1::4, 3, 0] = -np.inf
        p2[2::7, 5] = np.inf
    elif case == "grid":        # exact repeats: simplices that stall
        p1 = np.round(rng.normal(size=(1024, 12, 3)) * 4) * 250.0
        p2 = np.round((rng.normal(size=(1024, 12, 3)) * 0.7
                       + rng.normal(size=(1024, 1, 3)) * 0.9) * 4) * 250.0
    return (torch.from_numpy(p1.astype(np.float32)),
            torch.from_numpy(p2.astype(np.float32)))


@pytest.mark.parametrize("case", ["random", "coincident", "collinear",
                                  "coplanar", "tiny", "huge", "nan", "inf",
                                  "grid"])
def test_quad_iteration_matches_gjk_phase_on_degenerate_simplices(case):
    p1, p2 = _degenerate_hulls(case)
    active = torch.ones(p1.shape[0], dtype=torch.bool)
    active[::11] = False
    _same_phase(make_hull_support(p1, p2), active)


def _random_simplices():
    """(B,) tetrahedra, some with coincident, collinear or coplanar
    vertices, and at tiny and huge scales."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(4, 512, 3)).astype(np.float32)
    v[1, :64] = v[0, :64]                          # coincident
    v[2, 64:128] = 2 * v[1, 64:128] - v[0, 64:128]  # collinear
    v[3, 128:192, 2] = v[0, 128:192, 2] = v[1, 128:192, 2] = \
        v[2, 128:192, 2] = 0.5                      # coplanar
    v[:, 192:256] *= 1e-20
    v[:, 256:320] *= 1e20
    return [P3(*(torch.from_numpy(v[i, :, k].copy()) for k in range(3)))
            for i in range(4)]


def test_reused_values_are_the_plain_versions():
    """The identities K6a's reuse rests on, as the plain code writes each
    value: the containment's raw normal is the next face choice's, flat_tri's
    norm is face 2's, coplanar4's plane normal is face 2's cross times face
    2's reciprocal, and the mean carries over."""
    eps, epz = CFG.eps_coincide, CFG.eps_zero
    ns = _random_simplices()
    mn = pmean4(ns)
    faces = [lane_face(ns, mn, f, eps, epz) for f in range(4)]
    for f, (f0, f1, f2) in enumerate(FACE_IDX):
        # point_in_simplex's (lane_geom.py) and gjk_phase's face normal
        # (fused_gjk.py) are both this expression
        want = putz(pcross(ns[f0] - ns[f1], ns[f1] - ns[f2]), epz)
        for x, y in zip(faces[f]["raw"], want):
            assert same(x, y)
    f2 = faces[2]
    flat_norm = pnorm(pcross(ns[1] - ns[0], ns[2] - ns[1]))
    assert same(flat_norm, f2["n"])
    ok = ((torch.abs(f2["cr"].x) > epz) | (torch.abs(f2["cr"].y) > epz)
          | (torch.abs(f2["cr"].z) > epz))
    unit = pscale(f2["cr"], torch.where(ok, f2["r"], 0.0))
    for x, y in zip(unit, uninml(ns[0], ns[1], ns[2], epz)):
        assert same(x, y)     # equal values (a zero's sign aside)
    assert torch.equal(
        torch.abs(pdot(ns[3] - ns[0], unit)) < eps,
        torch.abs(dist_pf_sign(ns[3], ns[0], ns[1], ns[2], epz)) < eps)
    for x, y in zip(mn, pmean4(tuple(ns))):
        assert same(x, y)
    assert bool((f2["n"] < eps).any()) and bool((~ok).any())


# -- K6a's grid ---------------------------------------------------------------

def k6a_schedule(b, n_act, sms, pairs, blocks_per_sm):
    """The compact indices each quad runs GJK on and those each thread
    writes the inactive row of, as gjk_sub_shapes_kernel's loops walk
    them, on the grid its launcher sizes (resident_grid: the blocks the
    card holds at once, ``blocks_per_sm`` an SM, no more than the pairs
    need).  The kernel writes pair order[i] for each compact index i."""
    g = min(blocks_per_sm * sms, -(-b // pairs))
    threads = pairs * 4
    count = min(n_act, b)
    gjk, inactive = [], []
    for blk in range(g):
        for tid in range(threads):
            inactive += range(count + blk * threads + tid, b, g * threads)
            if tid % 4 == 0:
                gjk += range(blk + g * (tid // 4), count, g * pairs)
    return gjk, inactive


@pytest.mark.parametrize("pairs", [8, 16, 32, 64])
@pytest.mark.parametrize("blocks_per_sm", [1, 2, 4, 8])
def test_k6a_grid_covers_every_pair_once(pairs, blocks_per_sm):
    for b, n_act, sms in ((65536, 793, 132), (16381, 16381, 132),
                          (1021, 0, 132), (5, 5, 132), (997, 400, 2),
                          (300, 999, 132)):
        gjk, inactive = k6a_schedule(b, n_act, sms, pairs, blocks_per_sm)
        assert sorted(gjk) == list(range(min(n_act, b)))
        assert sorted(gjk + inactive) == list(range(b))


# -- K6b's block deal ---------------------------------------------------------

def k6b_block_deal(gjk, block, threads, pairs):
    """K6b's steps 2 and 3 for block ``block`` of a batch whose GJK lanes
    are ``gjk`` (numpy bool, B): each warp's ballot and popc, the prefix
    over the block's warps, and the list entries each quad takes.  Returns
    (the list, the pairs each quad ran in order)."""
    b = gjk.shape[0]
    warps = threads // 32
    ballots, counts = [], []
    for w in range(warps):
        bits = 0
        for lane in range(32):
            t = 32 * w + lane
            i = block * pairs + t
            if t < pairs and i < b and gjk[i]:
                bits |= 1 << lane
        ballots.append(bits)
        counts.append(bin(bits).count("1"))
    total = sum(counts)
    lanes = [None] * pairs
    for t in range(threads):
        w, lane = t >> 5, t & 31
        if ballots[w] >> lane & 1:
            base = sum(counts[:w])
            lanes[base + bin(ballots[w] & ((1 << lane) - 1)).count("1")] = \
                block * pairs + t
    quads = threads // 4
    ran = [[lanes[q] for q in range(qi, total, quads)] for qi in range(quads)]
    return lanes[:total], ran


@pytest.mark.parametrize("threads,pairs", [(128, 32), (128, 128), (64, 64),
                                           (128, 64)])
@pytest.mark.parametrize("fill", ["c3", "none", "all", "random"])
def test_k6b_deal_lists_every_gjk_lane_once_in_pair_order(threads, pairs,
                                                          fill):
    """Every GJK lane of a block is in its list exactly once, in pair order,
    and each is run by exactly one quad; B % 128 != 0 leaves a partial
    last block whose threads past B deal no lane."""
    b = 65533 if fill == "c3" else 1000
    if fill == "c3":               # c3's first 65,533 pairs
        a, bb = (ShapeBatch.from_numpy(*(x[:b] for x in side), device="cpu")
                 for side in fixtures.c3_pairs(0, 65536))
        retired, _ = fs.retirement(a, bb)
        gjk = fs.cf_shapes_plain(a.packed(), bb.packed(), retired,
                                 CFG).act.numpy()
    elif fill == "none":
        gjk = np.zeros(b, bool)
    elif fill == "all":
        gjk = np.ones(b, bool)
    else:
        gjk = np.random.default_rng(zlib.crc32(b"k6b")).random(b) < 0.3
    blocks = -(-b // pairs)
    busy = [blk for blk in range(blocks)
            if gjk[blk * pairs:(blk + 1) * pairs].any()]
    if fill == "c3":
        assert gjk.sum() > 700 and b % 128 != 0
        # the blocks that hold GJK lanes, and the partial last one
        check = sorted(set(busy) | {blocks - 1})
    else:
        check = range(blocks)
    for blk in check:
        listed, ran = k6b_block_deal(gjk, blk, threads, pairs)
        want = [i for i in range(blk * pairs, min((blk + 1) * pairs, b))
                if gjk[i]]
        assert listed == want
        flat = sorted(i for q in ran for i in q)
        assert flat == want
        if pairs <= threads // 4:           # a quad a lane: one round
            assert all(len(q) <= 1 for q in ran)
