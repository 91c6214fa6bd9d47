"""Device choice for the port's entry points.

Entry points run on the card unless the caller asks for the CPU by
passing ``device="cpu"`` (the tests do). Without a card and without that
request they raise: there is no silent CPU path.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "krasis_tpu_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        set_exact_matmul_flags()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def set_exact_matmul_flags() -> None:
    """The reference computes the router matmul and the MLA absorb einsums
    in true f32, and every bf16 product with f32 accumulation: TF32 and
    bf16 split-K reductions would change those results."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
