"""The portable hull query against the float64 reference oracle
(``tests/oracle_np.py``, a transliteration of the Fortran with a rebuilt
hull every EPA iteration): ``tests/test_oracle_diff.py``'s cases through
the port's ``gjkepa_batch`` in float64.

Held as ``docs/PARITY.md`` §2.2 holds the JAX package: no hit mismatch,
depth within 1e-6 on every converged oracle hit.  Where the minimum face
is unique (the normals agree within 1e-6) the normal agrees within 1e-5,
the nearest points' support values within 1e-7, the contact type exactly,
and the contact point within 1e-5 on all but 2% of the hits (a
single-vertex pick may tie); min-face ties (normals that differ) stay
within 2% of the hits.  Hulls of unequal sizes share a batch padded with
masked rows (repeated vertices would weigh twice in the contact point's
support sets).
"""

import numpy as np
import pytest
import torch

from gjkepa_tpu_torch import GJKEPAConfig, gjkepa_batch
from tests.conftest import cube, random_hull
from tests.oracle_np import OracleHalt, gjkepa_oracle

torch.set_num_threads(1)

DEPTH_TOL = 1e-6
NORMAL_TOL = 1e-6


def check_pairs(pairs, version=2):
    """Every pair through the port in one batch, then against the oracle;
    returns the statistics of the JAX suite's ``check_pair``."""
    n = max(max(len(a), len(b)) for a, b in pairs)

    def pad(side):  # padded rows masked out: the unpadded hull's contact
        v = np.stack([np.concatenate([x, np.zeros((n - len(x), 3))])
                      for x in side])
        m = np.arange(n)[None, :] < np.array([len(x) for x in side])[:, None]
        return torch.from_numpy(v), torch.from_numpy(m)
    (p1, m1), (p2, m2) = pad([a for a, _ in pairs]), pad([b for _, b in pairs])
    r = gjkepa_batch(p1, p2, m1, m2, cfg=GJKEPAConfig(version=version))
    stats = {"hits": 0, "halt": 0, "normal_tie": 0, "cp_mismatch": 0}
    for i, (a, b) in enumerate(pairs):
        try:
            o = gjkepa_oracle(a, b, version=version)
        except OracleHalt:
            stats["halt"] += 1
            continue
        assert bool(r.hit[i]) == o.hit, f"pair {i}: hit verdict differs"
        if not o.hit or o.epa_capped:
            continue
        stats["hits"] += 1
        assert float(r.depth[i]) == pytest.approx(o.depth, abs=DEPTH_TOL), i
        n_ours = r.normal[i].numpy()
        if float(n_ours @ o.normal) <= 1.0 - NORMAL_TOL:
            stats["normal_tie"] += 1
            continue
        np.testing.assert_allclose(n_ours, o.normal, atol=1e-5)
        if version != 3:       # v3 rewrites the normal the points follow
            np1, np2 = r.nearest_points[i].numpy()
            assert float(np1 @ o.normal) == pytest.approx(
                float(o.nearest_points[0] @ o.normal), abs=1e-7)
            assert float(np2 @ -o.normal) == pytest.approx(
                float(o.nearest_points[1] @ -o.normal), abs=1e-7)
        assert int(r.colli_type[i]) == o.colli_type, i
        if np.abs(r.contact_point[i].numpy() - o.contact_point).max() > 1e-5:
            stats["cp_mismatch"] += 1
    return stats


def _tight(stats, hits=1):
    assert stats["hits"] >= hits, stats
    assert stats["normal_tie"] <= max(1, stats["hits"] // 50), stats
    assert stats["cp_mismatch"] <= max(1, stats["hits"] // 50), stats


def test_axis_and_diagonal_offsets():
    pairs = [(cube([0, 0, 0]), cube([dx, 0, 0]))
             for dx in (0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 0.99, 1.01, 1.2, 1.8)]
    pairs += [(cube([0, 0, 0]), cube([t * 0.6, t * 0.5, t * 0.4]))
              for t in (0.1, 0.4, 0.8, 1.2)]
    pairs.append((cube([0, 0, 0], half=1.0), cube([0.1, 0.05, 0.0],
                                                   half=0.25)))
    _tight(check_pairs(pairs), hits=10)


def test_rotated_cubes(rng):
    pairs = []
    for _ in range(10):
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        pairs.append((cube([0, 0, 0]),
                      cube([0, 0, 0]) @ q.T + rng.normal(size=3) * 0.6))
    _tight(check_pairs(pairs))


def test_random_pairs_mixed(rng):
    pairs = [(random_hull(rng, 12, center=rng.normal(size=3) * 0.7),
              random_hull(rng, 12, center=rng.normal(size=3) * 0.7))
             for _ in range(120)]
    s = check_pairs(pairs)
    _tight(s, hits=12)
    assert s["halt"] <= 2, s


def test_deep_penetration_pairs(rng):
    pairs = [(random_hull(rng, 16, scale=2.0),
              random_hull(rng, 10, center=rng.normal(size=3) * 0.2,
                          scale=0.5)) for _ in range(30)]
    _tight(check_pairs(pairs), hits=10)


@pytest.mark.parametrize("version", [1, 3])
def test_contact_versions(rng, version):
    pairs = [(random_hull(rng, 10, center=rng.normal(size=3) * 0.5),
              random_hull(rng, 10, center=rng.normal(size=3) * 0.5))
             for _ in range(15)]
    s = check_pairs(pairs, version)
    assert s["cp_mismatch"] == 0, s


def test_oracle_sample_zero_hit_mismatches():
    """A 256-pair sample of deep and grazing pairs: zero hit mismatches and
    depth within 1e-6 (``chip_smoke.py`` phase 16 holds the card to the
    same)."""
    rng = np.random.default_rng(11)
    pairs = [(random_hull(rng, 16, center=rng.normal(size=3) * 0.3,
                          scale=1.5),
              random_hull(rng, 16, center=rng.normal(size=3) * 0.9))
             for _ in range(256)]
    _tight(check_pairs(pairs), hits=64)
