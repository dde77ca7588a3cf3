"""Conformance helpers: the divergence classifier of the census and the
C++ oracle's host side."""
