"""The port's own trimmed copies of the reference's framework-free
utilities (metrics registry, tracer, slice topology strings)."""
