"""Conformance helpers: the divergence classifier of the census."""
