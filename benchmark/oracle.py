"""Float64 reference of the hull-pair query: a frozen copy of the
repository's numpy/scipy oracle, a direct transliteration of the Fortran
reference (``GCLIB_GJKEPA.f90``, github.com/xiejihong0306/collision-detect-GJK-EPA).

It follows the reference's exact control flow: the always-tetra GJK update,
the stagnation-based miss verdicts, the rebuild-the-hull-each-iteration EPA
(``scipy.spatial.ConvexHull`` standing in for the reference's QuickHull) and
the contact-point versions 1-3.  It shares no code with the program under
test: the init-direction table below is the reference's own constant
(``GET_RANDOM_UNIT_VECTOR``, :1578-1689), copied as data.

Where the reference halts interactively (WRITE + PAUSE/STOP) this module
raises :class:`OracleHalt`; the benchmark leaves such pairs out of its
comparison.  Frozen: later changes to the repository's test oracle do not
reach it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

try:
    from scipy.spatial import ConvexHull
    from scipy.spatial import QhullError
except ImportError:  # pragma: no cover
    ConvexHull = None
    QhullError = Exception

DIRECTION_TABLE = np.array([
    [0.000001109357820885, 0.072093544214837393, 0.997397874913172555],
    [0.266483497218669374, -0.727347325988231153, 0.632417910157418883],
    [0.079214616132658941, -0.782543920607548071, -0.617535470164364719],
    [-0.993301267605208316, 0.106810772229378015, 0.044091390425458579],
    [0.082261341377368513, 0.991595302008176138, -0.099859044408155587],
    [-0.787452696781838490, 0.616178410256023601, 0.015569748404171571],
    [-0.247966562512464128, 0.750010049461640738, -0.613186357955148420],
    [-0.715817591888975313, 0.423804523888427931, 0.554972882827594716],
    [0.499764308041154848, 0.237809719054367125, -0.832875845448425078],
    [0.360748686617363812, 0.307777557994801998, 0.880416583157429655],
    [0.713138609686784886, -0.678418744074228530, 0.176582363396647901],
    [0.881992030996567422, 0.026379550968972942, -0.470525426039045791],
    [-0.267765386517834436, 0.464539693453386748, -0.844099858422679872],
    [0.513202226307113540, 0.794177664474205347, 0.325430963744568147],
    [0.266257765457365569, 0.689919118649417573, 0.673140707471819200],
    [-0.533214734590422568, 0.393416539739102400, 0.748936227642498564],
    [-0.623072641479377243, -0.654446770357797636, 0.428345547669355065],
    [0.584825748689458469, 0.437231667603634577, 0.683232985528625658],
    [-0.556342156780530561, -0.693940941632379182, -0.457087928209829908],
    [0.797251122953163582, -0.186816815361580540, -0.574012303394340728],
    [0.652717880922520921, 0.670487884243165855, -0.352711447230079078],
    [-0.119569576931363289, -0.933186657472575787, -0.338918542702544345],
    [0.662896092871913201, -0.734670864402726664, 0.144317327625279795],
    [-0.453865743569666802, 0.555714019359183631, 0.696554244478931106],
    [0.654083844194692787, -0.209153829113278511, 0.726931221320659904],
    [0.590510679076412859, 0.337909209878702432, 0.732880961531860775],
    [0.968625410428645917, -0.064469344047131227, -0.240017745073296679],
    [-0.836672384182689188, -0.337478629755403936, 0.431378599381644634],
    [0.415710848734430150, 0.722574771381445879, -0.552331594250728086],
    [-0.333326475889782536, 0.815058361243497620, -0.473891684077661635],
    [-0.652533192903382075, -0.591467557663984178, 0.473673474442383280],
    [0.394659527294562162, -0.550384256978558417, -0.735745218935055623],
    [-0.636304506189762753, 0.473703705794754570, 0.608868930492367122],
    [-0.719230459123433086, -0.158162890699728137, 0.676529413015133918],
    [0.629759138526492901, -0.491788561913722666, 0.601288148738358452],
    [0.584411917965700356, -0.367877772023600003, 0.723276333769192092],
    [0.870106618562407896, -0.204182999880998167, 0.448579730809907151],
    [0.529356795812083503, -0.718211329438827373, 0.451612520855297239],
    [0.733690094242977708, -0.622391387307088984, -0.272631264926984196],
    [-0.605777076602946218, -0.315061533953294726, 0.730595896022818714],
    [-0.761009425976650333, -0.636619547995314727, 0.124820690131605891],
    [-0.646761961270369112, -0.761942845893679443, -0.033794452875378959],
    [0.365154502536077674, 0.505749055061637143, -0.781588179658502025],
    [0.574247267419540908, 0.634851826576257938, 0.516917047652695638],
    [0.346341716472641781, -0.550932683186623917, -0.759289532410115098],
    [-0.794685184986554050, -0.055389826957407198, 0.604489391000797349],
    [-0.416259521322270454, -0.054995592820233065, -0.907581123469910711],
    [0.794777927582307919, 0.342095783921817331, -0.501296838660377997],
    [-0.338337965454608924, -0.286035970801144568, -0.896499216140138389],
    [-0.726532004741409887, -0.049688151104356579, -0.685333738937649595],
    [-0.603734615736470803, -0.585014438414317439, 0.541537275363678683],
    [-0.676560375498003186, -0.722348934167962309, 0.143101626868494480],
    [0.586582880385051575, 0.072766280975167824, -0.806613657702508258],
    [-0.755532705527683479, -0.071266043707085253, -0.651223066155029895],
    [-0.920701606636518566, 0.311540070620156373, 0.235056027225258340],
    [0.541712171882508864, -0.838526306892959261, 0.058494063654270075],
    [-0.408115455093796653, -0.092597310866135374, -0.908222171791651101],
    [-0.258240219479359101, -0.908622337155473581, 0.328203347736395479],
    [-0.061612129227968819, -0.446992987857170232, 0.892413141061087156],
    [0.788042672316281223, -0.496244917147545261, 0.364320914598434853],
    [-0.248619129130190686, 0.619445212796131295, -0.744631557869058658],
    [0.727207891810358387, -0.392604991169558049, -0.563054174123134521],
    [-0.730052156895783066, 0.157234865285751285, 0.665057174497340808],
    [0.600414670664006778, 0.750265884008508910, 0.276773059643389052],
    [-0.083928500830154310, 0.690568080639724524, 0.718381328230327632],
    [0.694831042024156353, 0.584804220606428005, -0.418585530806468986],
    [-0.111848450943919986, -0.781531383436509852, -0.613757786692161189],
    [-0.279182094755242194, -0.930461735000781665, -0.237272665234346397],
    [-0.689964963785805074, -0.305025070889099192, -0.656435872631251471],
    [0.633382581384791088, 0.583236672149216373, 0.508587740570539015],
    [0.466924244038473768, -0.606103736912413371, 0.643909939688702027],
    [-0.137658227056735444, -0.193627586092586290, -0.971369430457616478],
    [0.393853240338342958, 0.768953844741995574, 0.503576816117948800],
    [-0.132535470218959284, 0.729368436809752718, -0.671160213748950629],
    [0.159029880166712406, 0.267247506574191773, 0.950414787050390064],
    [0.585440601303706010, -0.650059126571057910, 0.484440331007677694],
    [0.086766095195569742, -0.926700911609081412, 0.365646092755564367],
    [0.404761320436991479, -0.409969869053845359, -0.817369549191842681],
    [-0.630382450683336315, 0.770188809015893039, -0.097093585458315548],
    [-0.042053492941287379, -0.611271645428856480, -0.790302776931813389],
    [0.929725661108754209, 0.077330619173836948, -0.360041900914436386],
    [-0.889604251783720934, -0.344981229410519730, -0.299319606044663511],
    [0.129702915764274479, -0.696106796017660678, -0.706124976318124986],
    [-0.796994723739967381, -0.420325416758673909, -0.433734889485847597],
    [-0.643021987392653815, -0.525087908251825164, 0.557499248732520325],
    [0.223259530927500754, -0.439307839166757808, 0.870151598456651798],
    [0.639217882809690274, 0.671377686488942249, 0.375036665382270096],
    [0.228323372420344811, -0.748223967023273318, -0.622920005119883879],
    [-0.632452534964462632, 0.397443937197173747, -0.664862472848508856],
    [-0.575267651846246730, 0.586755089131675400, 0.569899635126559057],
    [0.934572561750450670, 0.355419405776895792, 0.015848432742659273],
    [-0.122211293462219608, 0.261591882966958789, 0.957410093176425669],
    [0.418206651287156450, -0.714638510825073237, 0.560709368269252773],
    [-0.455037020713617735, 0.389115382040291002, 0.800956009553404180],
    [0.576937065595787169, -0.543479726634975457, 0.609732243758270287],
    [-0.094516770591717383, 0.753943490941892613, 0.650104447410771891],
    [0.489068888565033721, -0.424755340422356520, 0.761836283607213560],
    [0.986861350764715373, 0.139794765568494128, 0.081006776793618909],
    [-0.902962972513389861, -0.262938852206923646, 0.339883848203895222],
    [-0.712980642840275625, 0.087812143183863101, 0.695663446247195227],
], dtype=np.float64)

O = np.zeros(3)


class OracleHalt(Exception):
    """The reference would PAUSE/STOP (or hit undefined behavior) here."""


@dataclasses.dataclass
class OracleResult:
    hit: bool
    colli_type: int = 0
    nearest_points: np.ndarray = None
    normal: np.ndarray = None
    contact_point: np.ndarray = None
    depth: float = 0.0
    epa_capped: bool = False

    def __post_init__(self):
        if self.nearest_points is None:
            self.nearest_points = np.zeros((2, 3))
        if self.normal is None:
            self.normal = np.zeros(3)
        if self.contact_point is None:
            self.contact_point = np.zeros(3)


# ---------------------------------------------------------------------------
# math tools (ref :1193-1689)
# ---------------------------------------------------------------------------

def utzvec(v):
    n = np.linalg.norm(v)
    return np.zeros_like(v) if n < 1e-12 else v / n


def uninml(tri):
    c = np.cross(tri[1] - tri[0], tri[2] - tri[1])
    if np.any(np.abs(c) > 1e-12):
        return c / np.linalg.norm(c)
    return np.zeros(3)


def dist_pf_sign(p, tri):
    n = uninml(tri)
    if np.all(np.abs(n) < 1e-12):
        raise OracleHalt("DIST_PF_SIGN degenerate plane (ref :1369-1373)")
    return float(np.dot(p - tri[0], n))


def vec_pl(p, line):
    a, b = line
    ab = b - a
    d = a + np.dot(p - a, ab) / np.linalg.norm(ab) * utzvec(ab)
    return utzvec(d - p)


def foot_pl(p, line):
    u = utzvec(line[1] - line[0])
    return line[0] + np.dot(p - line[0], u) * u


def foot_ll(l1, l2):
    p1, q1 = l1
    p2, q2 = l2
    d1, d2, r = q1 - p1, q2 - p2, p1 - p2
    a, b, c = np.dot(d1, d1), np.dot(d1, d2), np.dot(d1, r)
    e, f = np.dot(d2, d2), np.dot(d2, r)
    d = a * e - b * b
    if abs(d) < 1e-12:
        m = (p1 + q1) / 2.0
        return np.stack([m, foot_pl(m, l2)])
    s = (b * f - c * e) / d
    t = (a * f - b * c) / d
    return np.stack([p1 + s * d1, p2 + t * d2])


def is_inside_pf(V, p):
    n = len(V)
    c = np.empty(n)
    for i in range(n):
        j = (i + 1) % n
        c[i] = (V[j, 0] - V[i, 0]) * (p[1] - V[i, 1]) - (V[j, 1] - V[i, 1]) * (p[0] - V[i, 0])
    c[np.abs(c) < 1e-12] = 0.0
    if not np.any(c > 1e-15):  # all-nonpositive quirk -> XOZ projection
        for i in range(n):
            j = (i + 1) % n
            c[i] = (V[j, 0] - V[i, 0]) * (p[2] - V[i, 2]) - (V[j, 2] - V[i, 2]) * (p[0] - V[i, 0])
    return not np.any(c[0] * c < 0.0)


_ID_FC = [[0, 2, 3], [0, 1, 3], [0, 1, 2], [1, 2, 3]]


def point_in_simplex(p, s):
    m = s.mean(axis=0)
    dist = np.empty(4)
    nml = np.empty((4, 3))
    for i, f in enumerate(_ID_FC):
        ab = s[f[0]] - s[f[1]]
        bc = s[f[1]] - s[f[2]]
        n = utzvec(np.cross(ab, bc))
        if np.dot(n, s[i] - m) < 0.0:
            n = -n
        nml[i] = n
        dist[i] = np.dot(s[i] - p, n)
    for i, f in enumerate(_ID_FC):
        if abs(dist[i]) < 1e-8 and is_inside_pf(s[f], p):
            return True
    return bool(np.all(dist > 0.0))


def overlap(pts):
    return all(np.all(np.abs(pts[i] - pts[j]) <= 1e-12)
               for i in range(len(pts)) for j in range(i + 1, len(pts)))


def sort_clock(pts):
    """Greedy CCW chain around the centroid (ref :1513-1575)."""
    if overlap(pts):
        return pts.copy()  # ref returns unset output; input order by convention
    n = len(pts)
    centroid = pts.mean(axis=0)
    normal = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    ordered = [pts[0]]
    for _ in range(1, n):
        best, best_ang = -1, np.inf
        for j in range(n):
            if any(np.array_equal(pts[j], o) for o in ordered):
                continue
            v1 = pts[j] - centroid
            v2 = ordered[-1] - centroid
            ang = np.arctan2(np.dot(normal, np.cross(v2, v1)), np.dot(v1, v2))
            ang = np.mod(ang + 2 * np.pi, 2 * np.pi)
            if ang < best_ang:
                best_ang, best = ang, j
        if best < 0:
            raise OracleHalt("SORT_CLOCK exact-duplicate points (UB in ref)")
        ordered.append(pts[best])
    return np.stack(ordered)


# ---------------------------------------------------------------------------
# support / broadphase (ref :1030-1062, :1165-1188)
# ---------------------------------------------------------------------------

def support_mapping(p1, p2, d):
    return p1[np.argmax(p1 @ d)] - p2[np.argmax(p2 @ -d)]


def rough_collision(p1, p2):
    c1, c2 = p1.mean(axis=0), p2.mean(axis=0)
    r1 = np.max(np.linalg.norm(p1 - c1, axis=1))
    r2 = np.max(np.linalg.norm(p2 - c2, axis=1))
    return np.linalg.norm(c1 - c2) <= r1 + r2 + 1.0


# ---------------------------------------------------------------------------
# GJK (ref :39-239, :1070-1157)
# ---------------------------------------------------------------------------

def update_simplex_gjk(p1, p2, s):
    m = s.mean(axis=0)
    edges = [(0, 2, 2, 3), (0, 1, 1, 3), (0, 1, 1, 2), (1, 2, 2, 3)]
    ref_v = [0, 0, 0, 1]
    keep = [[0, 2, 3], [0, 1, 3], [0, 1, 2], [1, 2, 3]]
    nml = np.empty((4, 3))
    dist = np.empty(4)
    for i, (a1, a2, b1, b2) in enumerate(edges):
        n = utzvec(np.cross(s[a1] - s[a2], s[b1] - s[b2]))
        if np.dot(n, s[ref_v[i]] - m) < 0.0:
            n = -n
        nml[i] = n
        dist[i] = np.dot(-n, s[ref_v[i]] - O)
    k = int(np.argmax(dist))
    sm = support_mapping(p1, p2, nml[k])
    return np.stack([s[keep[k][0]], s[keep[k][1]], s[keep[k][2]], sm])


def gjkepa_oracle(p1, p2, version=2, tol_ff=1.0):
    p1 = np.asarray(p1, dtype=np.float64)
    p2 = np.asarray(p2, dtype=np.float64)
    if not rough_collision(p1, p2):
        return OracleResult(hit=False)

    # init v1/v2 with retry (ref :82-112)
    it = 0
    while True:
        it += 1
        if it > 99:
            return OracleResult(hit=False)
        d = DIRECTION_TABLE[it - 1]
        s1 = support_mapping(p1, p2, d)
        s2 = support_mapping(p1, p2, -d)
        if not np.all(np.abs(s1 - s2) < 1e-8):
            break

    # v3 (ref :115-127)
    d = vec_pl(O, np.stack([s1, s2]))
    s3 = support_mapping(p1, p2, d)
    if np.all(np.abs(s3 - s1) < 1e-8) or np.all(np.abs(s3 - s2) < 1e-8):
        return OracleResult(hit=False)

    # v4 (ref :130-170)
    d = utzvec(np.cross(s2 - s1, s3 - s2))
    vo = O - s3
    if abs(np.dot(vo, d)) < 1e-8 and is_inside_pf(np.stack([s1, s2, s3]), O):
        # Reference UB: stale 4th vertex (:143-145).  Convention shared with
        # the TPU engine: fresh support along the (unflipped) tri normal,
        # opposite side if coplanar.
        s4e = support_mapping(p1, p2, d)
        tri = np.stack([s1, s2, s3])
        try:
            cop = abs(dist_pf_sign(s4e, tri)) < 1e-8
        except OracleHalt:
            cop = True
        if cop:
            s4e = support_mapping(p1, p2, -d)
        return _epa(p1, p2, np.stack([s1, s2, s3, s4e]), version, tol_ff)

    if np.dot(vo, d) < 0.0:
        d = -d
    s4 = support_mapping(p1, p2, d)
    if abs(dist_pf_sign(s4, np.stack([s1, s2, s3]))) < 1e-8:
        return OracleResult(hit=False)
    simplex = np.stack([s1, s2, s3, s4])
    if point_in_simplex(O, simplex):
        return _epa(p1, p2, simplex, version, tol_ff)

    # iterate loop (ref :178-236)
    last1 = np.zeros((4, 3))
    last2 = np.zeros((4, 3))
    it = 0
    while True:
        it += 1
        if it > 50:
            return OracleResult(hit=False)
        last2, last1 = last1, simplex
        simplex = update_simplex_gjk(p1, p2, simplex)
        if np.linalg.norm(np.cross(simplex[1] - simplex[0], simplex[2] - simplex[1])) < 1e-8:
            return OracleResult(hit=False)
        if abs(dist_pf_sign(simplex[3], simplex[:3])) < 1e-8:
            return OracleResult(hit=False)
        if point_in_simplex(O, simplex):
            return _epa(p1, p2, simplex, version, tol_ff)
        is_over = all(
            np.all(np.abs(simplex[i] - last1[i]) < 1e-8)
            or np.all(np.abs(simplex[i] - last2[i]) < 1e-8)
            for i in range(4)
        )
        if is_over:
            return OracleResult(hit=False)


# ---------------------------------------------------------------------------
# EPA (ref :242-346, :863-1022)
# ---------------------------------------------------------------------------

def _quickhull_faces(pts):
    if ConvexHull is None:
        raise OracleHalt("scipy unavailable")
    try:
        h = ConvexHull(pts, qhull_options="Qt")
    except (QhullError, ValueError) as e:
        raise OracleHalt(f"QuickHull failed: {e}") from e
    return pts[h.simplices]


def _unique_rows(pts):
    """getHullMeshesVertex: face soup -> unique vertex list (exact dedup)."""
    seen = []
    for row in pts:
        if not any(np.array_equal(row, s) for s in seen):
            seen.append(row)
    return np.stack(seen)


def _update_epa(p1, p2, poly1):
    dist1 = np.array([abs(dist_pf_sign(O, f)) for f in poly1])
    k = int(np.argmin(dist1))
    min_val = float(np.min(dist1))
    d = uninml(poly1[k])
    dot = np.dot(poly1[k, 0] - O, d)
    if abs(dot) < 1e-12:
        m = poly1.reshape(-1, 3).mean(axis=0)
        dot = np.dot(poly1[k, 0] - m, d)
    if dot <= -1e-12:
        d = -d

    spmp = support_mapping(p1, p2, d)
    scat = _unique_rows(poly1.reshape(-1, 3))
    scat = np.vstack([scat, spmp])
    if abs(min_val) < 1e-12:
        scat = np.vstack([scat, support_mapping(p1, p2, -d)])

    poly2 = _quickhull_faces(scat)
    dist2 = np.array([abs(dist_pf_sign(O, f)) for f in poly2])
    k2 = int(np.argmin(dist2))
    min_val2 = float(np.min(dist2))
    d2 = uninml(poly2[k2])
    if np.dot(poly2[k2, 0] - O, d2) < 0.0:
        d2 = -d2

    if len(dist1) == len(dist2):
        if np.all(np.abs(np.sort(dist1) - np.sort(dist2)) < 1e-8):
            return False, poly2, min_val2, d2
        return True, poly2, 0.0, np.zeros(3)
    if len(dist1) > len(dist2):  # QuickHull merged a duplicate support
        return False, poly2, min_val2, d2
    return True, poly2, 0.0, np.zeros(3)


def _epa(p1, p2, simplex, version, tol_ff):
    poly = np.stack([
        simplex[[0, 1, 2]], simplex[[0, 2, 3]],
        simplex[[0, 1, 3]], simplex[[1, 2, 3]],
    ])
    it = 0
    while True:
        it += 1
        if it > 99:
            # ref: WRITE + PAUSE, outputs stay zeroed (:299-303)
            return OracleResult(hit=True, epa_capped=True)
        is_exp, poly, depth, nml = _update_epa(p1, p2, poly)
        if not is_exp:
            break

    nearest = _nearest_points(p1, p2, nml)
    if version == 1:
        point = _collision_point_01(p1, p2, nml)
    elif version == 2:
        point = _collision_point_02(p1, p2, nml)
    elif version == 3:
        point, nml = _collision_point_03(p1, p2, nml)
    else:
        raise OracleHalt("unknown version (ref :337-339)")
    ctype = _collision_type(p1, p2, nml, tol_ff)
    return OracleResult(hit=True, colli_type=ctype, nearest_points=nearest,
                        normal=nml, contact_point=point, depth=depth)


# ---------------------------------------------------------------------------
# contact derivation (ref :353-855)
# ---------------------------------------------------------------------------

def _nearest_points(p1, p2, nml):
    i1 = int(np.argmax(p1 @ nml))
    i2 = int(np.argmax(p2 @ -nml))
    return np.stack([p1[i1], p2[i2]])


def _collision_type(p1, p2, nml, tol):
    c = int(np.sum(p1 @ nml > np.max(p1 @ nml) - tol))
    d = int(np.sum(p2 @ -nml > np.max(p2 @ -nml) - tol))
    return 2 if (c >= 3 and d >= 3) else 1


def _sloppy_top2(p, d):
    max_dot, i1, i2 = -np.inf, -1, -1
    dots = p @ d
    for i in range(len(p)):
        if dots[i] > max_dot - 1e-8:
            max_dot = dots[i]
            i2 = i1
            i1 = i
    if i2 < 0:
        i2 = i1
    return i1, i2


def _collision_point_01(p1, p2, nml):
    a1, a2 = _sloppy_top2(p1, nml)
    b1, b2 = _sloppy_top2(p2, -nml)
    if a1 == a2 and b1 == b2:
        return (p1[a1] + p2[b1]) / 2.0
    if a1 != a2 and b1 == b2:
        return p2[b1].copy()
    if a1 == a2 and b1 != b2:
        return p1[a1].copy()
    dots = p1 @ nml
    sel = dots > np.max(dots) - 1e-1
    return p1[sel].mean(axis=0)


def _collision_point_02(p1, p2, nml):
    d1 = p1 @ nml
    d2 = p2 @ -nml
    s1 = p1[d1 > np.max(d1) - 1e-1]
    s2 = p2[d2 > np.max(d2) - 1e-1]
    n1, n2 = len(s1), len(s2)

    def case_04(poly, edge):
        poly_sorted = sort_clock(poly)
        c = sum(bool(is_inside_pf(poly_sorted, e)) for e in edge)
        if c == 0:
            return foot_pl(poly.mean(axis=0), edge)
        if c in (1, 2):
            return (edge[0] + edge[1]) / 2.0
        raise OracleHalt("branch_case_04 impossible count (ref :635-637)")

    if n1 == 1 and n2 == 1:
        return (s1[0] + s2[0]) / 2.0
    if n1 == 1 and n2 >= 2:
        return s1[0].copy()
    if n1 >= 2 and n2 == 1:
        return s2[0].copy()
    if n1 == 2 and n2 == 2:
        feet = foot_ll(s1[:2], s2[:2])
        return (feet[0] + feet[1]) / 2.0
    if n1 == 2 and n2 >= 3:
        return case_04(s2, s1[:2])
    if n1 >= 3 and n2 == 2:
        return case_04(s1, s2[:2])
    if n1 >= 3 and n2 >= 3:
        return s1.mean(axis=0)
    raise OracleHalt("get_collisionPoint_02 fall-through (ref :499-501)")


def _collision_point_03(p1, p2, nml):
    max_dot, idx = -np.inf, 0
    dots = p2 @ -nml
    for i in range(len(p2)):
        if dots[i] > max_dot - 1e-8:
            max_dot = dots[i]
            idx = i
    point = p2[idx].copy()
    point[2] = p1[:, 2].mean()
    new_nml = nml.copy()
    new_nml[2] = 0.0
    new_nml = new_nml / np.linalg.norm(new_nml)
    return point, new_nml
