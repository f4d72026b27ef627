"""Inner convex-QP engines."""
