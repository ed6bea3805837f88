"""circom_compat_tpu_torch: the Groth16 prover and trusted setup of
circom_compat_tpu, ported to PyTorch with hand-written CUDA kernels for
Hopper (sm_90a).

Entry points: `models.groth16_device` (DeviceProvingKey, prove_prepared,
prove), the `models.groth16.Groth16` facade, and the setup in `models`
(generate_parameters_from_matrices, generate_random_parameters) with
`circom.zkey_writer.write_zkey`. They run on the card unless the caller
passes device="cpu", where every kernel wrapper takes its plain PyTorch
version.
"""

__version__ = "0.1.0"
