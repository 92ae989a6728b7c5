"""Ported operations: geometry, kernels with their plain versions, contact
rows."""
