"""krasis_tpu_torch — the PyTorch/CUDA port of krasis_tpu for one NVIDIA H100.

Plain tensor work is PyTorch; every Pallas kernel of the ported path is a
CUDA kernel written by hand for sm_90a (``csrc/``), built with nvcc at
first use (``build.py``). The package imports neither jax nor krasis_tpu.
Entry points run on the card unless the caller passes ``device="cpu"``,
where each kernel wrapper runs its plain PyTorch version.
"""

from .config import ModelConfig, QuantConfig, preset_config  # noqa: F401
