"""ccvpe_tpu_torch — the PyTorch/CUDA port of ccvpe_tpu for NVIDIA Hopper.

The JAX package `ccvpe_tpu` stays the reference; this package is held
against it module by module (tests/test_torch_*.py). It imports torch,
numpy and the standard library only — never jax, flax, optax or any module
of `ccvpe_tpu`.

Layout (bottom-up):
  core/    ModelConfig and presets (own copy)
  csrc/    hand-written CUDA C++ kernels + the nvcc builder
  ops/     SAME/circular padding, rolled correlation (plain + CUDA), pose
  nn/      EfficientNet-B0, descriptor heads, decoder stages
  models/  the configurable CVM
  train/   device_normalize and the scalar eval step
  utils/   JAX variables -> reference-named state dict
  serve.py InferenceEngine, export_program / load_program

Importing the package registers B1's and B2's forwards as the ops
ccvpe_tpu_torch::corr_fwd and ::lmu_fwd, which an exported program
(serve.py::load_program) calls; nothing is built until a kernel runs.
"""

__version__ = "0.1.0"

from ccvpe_tpu_torch.ops import corr_cuda as _corr_cuda  # noqa: E402,F401
from ccvpe_tpu_torch.ops import lmu_cuda as _lmu_cuda  # noqa: E402,F401
