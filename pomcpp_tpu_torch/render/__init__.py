"""Host-side rendering of the port's game state."""

from .ascii import print_state, render_state

__all__ = ["print_state", "render_state"]
