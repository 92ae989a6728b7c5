"""Shape models of the port: analytic primitives (``shapes``)."""

from .shapes import (BOX, CAPSULE, CYLINDER, SPHERE, ShapeBatch, boxes,
                     capsules, concat_shapes, cylinders,
                     make_shape_pair_support, shape_support_world, spheres)

__all__ = ["SPHERE", "BOX", "CAPSULE", "CYLINDER", "ShapeBatch", "spheres",
           "boxes", "capsules", "cylinders", "concat_shapes",
           "shape_support_world", "make_shape_pair_support"]
