"""State manifold and free-flyer rigid-body dynamics."""
