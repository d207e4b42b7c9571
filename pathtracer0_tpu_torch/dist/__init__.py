"""Rendering over several devices (dist/mesh.py) and several processes
(dist/multihost.py)."""
