"""Host-side utilities (logging, metrics)."""
