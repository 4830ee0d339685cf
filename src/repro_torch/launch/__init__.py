"""Serving and training drivers and the device meshes under them (port of
``src/repro/launch``)."""
