"""Launchers (``repro.launch``): ``serve`` (the LM slot engine),
``render_serve`` and ``train`` (the LM trainer) so far."""
