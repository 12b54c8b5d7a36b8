"""Mesh-sharded serving (port of ``repro/sharding/serving.py``)."""
