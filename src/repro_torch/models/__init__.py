"""The LM zoo (``repro.models``): configs, params, attention, the dense
and MoE FFNs, the Mamba-2 SSD layer, the transformer and the ``lm.build``
dispatch, for the dense, MoE, SSM and hybrid families (the VLM prefix and
the encoder-decoder wait)."""
