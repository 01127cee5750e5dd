"""Climate components."""
