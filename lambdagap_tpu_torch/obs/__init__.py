"""Observability primitives of the port (``reservoir``)."""
