"""repro_torch subpackage (port of ``src/repro/roofline/``)."""
