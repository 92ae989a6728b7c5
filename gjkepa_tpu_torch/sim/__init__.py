"""Rigid-body mini-sim: falling boxes (``rigid``)."""

from .rigid import SimConfig, SimState, init_boxes, sim_step

__all__ = ["SimState", "SimConfig", "init_boxes", "sim_step"]
