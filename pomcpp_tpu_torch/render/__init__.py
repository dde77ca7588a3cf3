"""Host-side rendering of the port's game state."""

from .ascii import (
    print_state,
    render_dependency,
    render_dependency_chain,
    render_path,
    render_rmap,
    render_state,
)

__all__ = ["print_state", "render_dependency", "render_dependency_chain",
           "render_path", "render_rmap", "render_state"]
