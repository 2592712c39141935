"""Model bundles of the port (counterpart of ``repro.configs``)."""
