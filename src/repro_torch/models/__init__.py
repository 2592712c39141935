"""The LM zoo (``repro.models``): configs, params, attention, the dense
FFN, the transformer and the ``lm.build`` dispatch, dense family only."""
