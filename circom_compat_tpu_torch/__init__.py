"""circom_compat_tpu_torch: the Groth16 prover and trusted setup of
circom_compat_tpu, ported to PyTorch with hand-written CUDA kernels for
Hopper (sm_90a).

Entry points: the `models.groth16.Groth16` facade (`prove` over a
`circom.circuit.CircomCircuit`, `create_proof_with_reduction_and_matrices`,
`verify_proof`), `models.groth16_device` (DeviceProvingKey, prove_prepared),
the setup in `models` (generate_parameters_from_matrices,
generate_random_parameters) with `circom.zkey_writer.write_zkey`,
`ops.msm.msm_g1` / `msm_g2`, `models.batch.BatchProver`, `server.ProveServer`
and the CLI (`python -m circom_compat_tpu_torch`). Circom artifacts:
`circom.r1cs`, `circom.wtns`, `circom.zkey`, `circom.builder`, and the WASM
witness interpreter in `witness`. They run on the card unless the caller
passes device="cpu" (`--device cpu`), where every kernel wrapper takes its
plain PyTorch version.
"""

__version__ = "0.1.0"
