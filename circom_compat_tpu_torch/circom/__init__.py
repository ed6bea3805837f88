"""Artifact layer: r1cs and wtns readers, the circuit, the builder, the zkey
reader and writer, and the host QAP oracles."""
