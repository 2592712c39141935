"""Plain-torch semantics of the ASDR renderer (counterpart of ``repro.core``)."""
