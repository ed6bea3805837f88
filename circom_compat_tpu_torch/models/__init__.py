"""Prover: device proving key, prove core and the Groth16 facade."""
