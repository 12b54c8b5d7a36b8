"""Sharding of the port: the logical-axis rules (``rules.py``), the model
code's contexts (``context.py``), arrays in blocks over a training mesh
(``arrays.py``), and mesh-sharded serving (``serving.py``); ports of
``repro/sharding/``."""
