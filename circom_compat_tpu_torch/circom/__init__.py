"""Artifact layer: zkey reader and the host witness-map oracle."""
