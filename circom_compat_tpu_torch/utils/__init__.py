"""Circuit helpers."""
