"""Serving and training drivers (port of ``src/repro/launch``; its mesh
helpers are ROADMAP module item 13, so this package imports nothing)."""
