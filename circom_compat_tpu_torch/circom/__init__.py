"""Artifact layer: zkey reader and writer, and the host QAP oracles."""
