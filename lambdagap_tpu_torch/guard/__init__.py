"""Serving degradation primitives (``degrade``)."""
