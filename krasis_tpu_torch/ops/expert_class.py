"""Which numeric form an expert stack takes: fused or two-stage.

The reference sends a model to its fused MoE kernels or to their
two-stage forms by the packed size of one expert
(``krasis_tpu/ops/moe_pallas.py`` ``supported``, ``krasis_tpu/ops/
gmm_pallas.py`` ``gmm_fused_supported``). With bf16 activations the two
forms round at different points: the two-stage decode form rounds the f32
h to bf16 before SwiGLU, the fused one applies SwiGLU to the f32 h. The
limits below are therefore not memory limits of this card: they are the
rule that gives a model the same rounding points in both packages, and
the port keeps them at the reference's values. Moving the boundary on
measurements of this card would be a recorded departure from the
reference's bf16 numerics.
"""

from __future__ import annotations

from ..quant import QTensor

# packed w13 + w2 bytes of one pick, above which decode takes the
# two-stage gathered form
MAX_FUSED_PICK_BYTES = int(4.75 * 1024 * 1024)
# packed bytes of one expert's w13 or w2 block, above which prefill takes
# the two-stage grouped form
MAX_FUSED_BLOCK_BYTES = 4 * 1024 * 1024


def _packed_bytes(w: QTensor) -> int:
    return w.q.shape[-2] * w.q.shape[-1]


def decode_fused(w13: QTensor, w2: QTensor) -> bool:
    """The reference's ``moe_pallas.supported``: one fused gathered kernel
    per pick (K3 / K5) rather than two gathered products (K6a / K6)."""
    H, I = w13.k_dim, w2.k_dim
    if H != w2.n_dim or 2 * I != w13.n_dim or w13.n_dim % 128 or H % 128:
        return False
    return _packed_bytes(w13) + _packed_bytes(w2) <= MAX_FUSED_PICK_BYTES


def decode_fused_int8(w13: QTensor, w2: QTensor) -> bool:
    """``moe_pallas.w4a8_supported``: the fused class with group-aligned K."""
    return (decode_fused(w13, w2) and w13.k_dim % w13.group_size == 0
            and w2.k_dim % w13.group_size == 0)


def prefill_fused(w13: QTensor, w2: QTensor) -> bool:
    """The reference's ``gmm_fused_supported``: grouped GEMM with the SwiGLU
    epilogue (K4) rather than two grouped GEMMs with SwiGLU between (K7)."""
    if w13.bits not in (4, 8) or w2.bits not in (4, 8):
        return False
    N13, H, I = w13.n_dim, w2.n_dim, w2.k_dim
    if N13 != 2 * I or N13 % 128 or H % 128 or I % 128:
        return False
    return (_packed_bytes(w13) <= MAX_FUSED_BLOCK_BYTES
            and _packed_bytes(w2) <= MAX_FUSED_BLOCK_BYTES)
