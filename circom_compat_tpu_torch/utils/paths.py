"""Paths of the reference checkout and the package's cache, derived from
this file's location or set by environment variables:

- CIRCOM_TPU_REFERENCE: root of the upstream reference checkout (its
  test vectors and the Solidity verifier's compiled artifact); default
  <repo>/reference.
- CIRCOM_TPU_CACHE: scratch directory for build outputs; default
  <repo>/.cache.

The copy of circom_compat_tpu/utils/paths.py without its XLA compile cache.
"""

from __future__ import annotations

import os
import pathlib

_PKG = pathlib.Path(__file__).resolve().parent.parent  # circom_compat_tpu_torch/


def repo_root() -> pathlib.Path:
    return _PKG.parent


def reference_root() -> pathlib.Path:
    return pathlib.Path(os.environ.get("CIRCOM_TPU_REFERENCE", repo_root() / "reference"))


def verifier_artifact() -> pathlib.Path:
    """The solc/hardhat artifact of the reference's TestVerifier contract."""
    return reference_root() / "tests" / "verifier_artifact.json"


def cache_dir() -> pathlib.Path:
    d = pathlib.Path(os.environ.get("CIRCOM_TPU_CACHE", repo_root() / ".cache"))
    d.mkdir(parents=True, exist_ok=True)
    return d
