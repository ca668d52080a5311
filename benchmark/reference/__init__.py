"""The benchmark's plain reference and frozen yardsticks.

Plain ``hashlib`` and NumPy only: nothing here imports torch, JAX, the
JAX package or the port, and nothing takes an object the port made.
The reference works out digests, BEP 52 trees, metainfo and bitfields
again from the bytes the benchmark generated, and the yardstick
(``yardstick.py``) holds the frozen operation, byte and peak model that
every roofline share is read against.
"""
