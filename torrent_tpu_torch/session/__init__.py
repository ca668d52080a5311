"""Session-facing adapters (this slice ports only the BEP 52 geometry, ``v2``)."""
