"""Launchers (``repro.launch``): ``render_serve`` only so far."""
