"""Named host ranges around the program's steps, seen only by a profiler.

``span(name)`` is a ``torch.profiler.record_function`` range while a
profiler session is open in this thread, and one shared no-op context
otherwise: with no profiler a span allocates nothing and enters no
dispatcher.  The ranges land in the profiler's own session, on the clock
of its CUDA activity.  No span reads the device or synchronises.

Names are ``gjkepa.<step>``: the public entry (its function's name), a
kernel's dispatcher (``k1`` ... ``k13``), the glue between kernels
(``order``, ``fill``, ``broadphase``, ``contact_rows``), and the host read
of the hit count that sizes K2's or K13's face store in device memory
(``store_read``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["span", "spanned"]

_OFF = contextlib.nullcontext()
_enabled = torch.autograd._profiler_enabled


def span(name: str):
    """A profiler range named ``name``, or the shared no-op context."""
    if _enabled():
        return torch.profiler.record_function(name)
    return _OFF


def spanned(name: str):
    """Decorate a function that is one step as a whole with ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call
    return wrap
