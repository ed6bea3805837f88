"""Multi-device and multi-process provers: the JAX package's parallel/ over torch devices and torch.distributed."""
