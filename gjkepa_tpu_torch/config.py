"""Static configuration of the narrow-phase engine.

Port of ``gjkepa_tpu/config.py:24-82``: the same frozen dataclass, field
names, defaults and float32 ladder.  The system has no weights; its
"parameters" are this config plus the direction table, so
:meth:`GJKEPAConfig.from_reference` carries a JAX-side config across.

Reference values (the Fortran ``GCLIB_GJKEPA.f90``):
  - eps_coincide = 1e-8   (:106,123,140,157,199,203,222-223,726,741,994,1248)
  - eps_zero     = 1e-12  (:905,910,935,1301,1350,1369,1392,1404,1474)
  - support_set_tol = 0.1 (:471-472,792)  contact-point support clustering
  - broadphase_tol  = 1.0 (:1172)         bounding-sphere inflation
  - init_max_iters  = 99  (:86)
  - gjk_max_iters   = 50  (:186)
  - epa_max_iters   = 99  (:299)
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GJKEPAConfig:
    """Numerical contract of a narrow-phase query."""

    # -- epsilon ladder (reference defaults, float64) ------------------------
    eps_coincide: float = 1e-8      # "same point" / coplanarity / convergence
    eps_zero: float = 1e-12         # degenerate normals, on-face tests
    support_set_tol: float = 0.1    # support-set clustering for contact points
    broadphase_tol: float = 1.0     # bounding-sphere slack
    face_contact_tol: float = 1.0   # TOL_FF_: face-face classification (:45)

    # -- iteration caps -------------------------------------------------------
    init_max_iters: int = 99        # init-direction retries, then give up
    gjk_max_iters: int = 50         # GJK loop cap, then non-hit
    epa_max_iters: int = 99         # EPA expansion cap, then status=EPA_CAP

    # -- EPA fixed-shape capacities (not in the reference) --------------------
    epa_max_verts: int = 64
    epa_max_faces: int = 124        # 2 * epa_max_verts - 4

    # -- contact-point algorithm version (reference :329-340) -----------------
    # 1 = "experimental", 2 = "general", 3 = "stator-rotor special"
    version: int = 2

    def replace(self, **kw) -> "GJKEPAConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def for_f32(scale: float = 1.0) -> "GJKEPAConfig":
        """Tolerance ladder rescaled for float32.

        The ladder is absolute, so it assumes scene coordinates of order 1
        (magnitudes up to ~100).  For larger scenes pass the characteristic
        ``scale``: length-like tolerances scale linearly, the
        degenerate-normal guard ``eps_zero`` quadratically.
        """
        return GJKEPAConfig(eps_coincide=1e-5 * scale,
                            eps_zero=1e-8 * scale * scale,
                            support_set_tol=0.1 * scale,
                            broadphase_tol=1.0 * scale,
                            epa_max_verts=40, epa_max_faces=80)

    @classmethod
    def from_reference(cls, fields: dict) -> "GJKEPAConfig":
        """Build from ``dataclasses.asdict`` of a JAX-package config.

        Raises ValueError on a missing or unknown field, so the two
        packages cannot drift apart silently."""
        names = {f.name for f in dataclasses.fields(cls)}
        if set(fields) != names:
            raise ValueError(
                f"config fields differ: missing {sorted(names - set(fields))}, "
                f"unknown {sorted(set(fields) - names)}")
        return cls(**fields)


DEFAULT_CONFIG = GJKEPAConfig()
