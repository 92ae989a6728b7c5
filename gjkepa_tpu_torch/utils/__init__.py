"""Host utilities of the port: convex-hull preprocessing (``hull``)."""
