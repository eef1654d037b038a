"""Host-side utilities: configuration, logging, metrics."""
