"""The least time a kernel could take on the card, from the work its inputs
need.

The bound of a launch is the larger of two times: the bytes its inputs and
outputs need, each read or written once, at the HBM bandwidth, and its
float32 operations at the float32 peak outside the tensor cores.  The peaks
are the NVIDIA H100 SXM's published ones (3.35 TB/s, 67 TFLOP/s), which
assume the card's full 700 W power limit.  The operation model is the
repository's kernel table's (``work()`` in the card smoke test), copied
here with its constants, and fed from the lanes, vertex counts and
iteration counts that a call's own outputs report, so it counts the work
these inputs need, however the program does it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_OPS_PER_S = 67e12          # H100 SXM float32, no tensor cores
PEAKS = "H100 SXM published peaks: 3.35 TB/s HBM, 67 TFLOP/s float32"

# The operation model: float32 operations of each step.
VERTEX_OPS = 5          # one vertex of a support scan: 3 multiplies, 2 adds
SPHERE_OPS = 12         # one vertex of a bounding-sphere pass
GJK_INIT_PROBES = 6     # support probes of the v1-v4 init
GJK_ITER_OPS = 400      # face normals, selection and tests of an iteration
EPA_FACE_OPS = 20       # min scan, repeat test and visibility, per face
EPA_FACES = 48          # faces scanned per EPA iteration (the first tier)
DIST_ITER_OPS = 500     # the 15 candidates of a distance iteration

# Bytes a lane reads and writes besides its two hulls (12 bytes a vertex).
K1_LANE_BYTES = 61      # K1: status, hit, iterations, separation, simplex
K2_LANE_BYTES = 56 + 24     # K2: simplex and order in; depth, normal, out
K8_LANE_BYTES = 34      # K8: distance, witnesses, flags, iterations


def least_s(lanes: int, bytes_per_lane: float, ops: float):
    """(seconds, "bytes" or "operations"): the least time to move ``lanes
    * bytes_per_lane`` bytes and to do ``ops`` float32 operations."""
    t_bytes = lanes * bytes_per_lane / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gjk_ops(active: int, iters: int, probe_ops: float) -> float:
    """The GJK phase: the init's probes on each active lane, one probe and
    the tests of each iteration."""
    return ((active * GJK_INIT_PROBES + iters) * probe_ops
            + iters * GJK_ITER_OPS)


def epa_ops(iters: int, probe_ops: float) -> float:
    """The EPA ladder: a probe and a face scan an iteration."""
    return iters * (probe_ops + EPA_FACES * EPA_FACE_OPS)


def k1(lanes: int, vertices: int, active: int, gjk_iters: int):
    """K1 (``gjk_hulls``): a bounding sphere over every lane, GJK over the
    ``active`` lanes (those the sphere did not reject)."""
    return least_s(lanes, vertices * 12 + K1_LANE_BYTES,
                   lanes * vertices * SPHERE_OPS
                   + gjk_ops(active, gjk_iters, VERTEX_OPS * vertices))


def k2(hits: int, vertices: int, epa_iters: int):
    """K2 (``epa_hulls``): the EPA ladder over the hit lanes."""
    return least_s(hits, vertices * 12 + K2_LANE_BYTES,
                   epa_ops(epa_iters, VERTEX_OPS * vertices))


def k8(lanes: int, vertices: int, iters: int):
    """K8 (``distance_hulls``): distance GJK over every lane, an initial
    probe a lane and one a loop iteration."""
    return least_s(lanes, vertices * 12 + K8_LANE_BYTES,
                   (lanes + iters) * VERTEX_OPS * vertices
                   + iters * DIST_ITER_OPS)
