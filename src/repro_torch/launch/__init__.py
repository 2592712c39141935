"""Launchers (``repro.launch``): ``serve`` (the LM slot engine) and
``render_serve`` so far."""
