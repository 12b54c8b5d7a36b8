"""Serving runtime of the port: page pool + allocator, sampling, engine."""
