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

The predicates here are the reference's, copied: they decide the numeric
form of a call (``ops/moe.py`` ``route``), and each form the reference
runs on its kernels runs on the port's (whose wrappers raise on the card
for stacks they do not take). One departure in dispatch,
with the same function: the reference sends biased experts (GPT-OSS) and
stacks its gathered kernels decline to the plain ``moe_forward_gathered``
(bf16 rows, h rounded to bf16, + the bf16 w13 bias, the activation, + the
f32 w2 bias); the port runs that form on K6's two launches with the biases
added between them, at the same rounding points, wherever K6 takes both
stacks — also under ``expert_activation="int8"``, as the reference's form
has bf16 rows there too. The prefill half is the same departure: such
stacks in the grouped regime go to the reference's plain
``moe_forward_ragged``, which the port runs on K7's two launches with the
biases added between them, at that form's rounding points, wherever K7
takes both stacks (N a multiple of 64: its last column CTA may be half
full) — whatever ``prefill_fused`` says, since the bias comes between the
bf16 rounding of h and the activation, where K4's epilogue has no room.
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


def gathered(w) -> bool:
    """The reference's ``moe_pallas.gathered_qmm_supported``: a quantized
    stack whose width is whole 128-lane tiles takes the two-stage gathered
    form in decode and the grouped kernels in prefill. Its bound on the
    bytes of one tile is a limit of the TPU's fast memory that no model of
    the repository reaches; it is not carried over."""
    return isinstance(w, QTensor) and w.q.dim() in (3, 4) and w.n_dim % 128 == 0


def gathered_int8(w) -> bool:
    """``moe_pallas.gathered_qmm_a8_supported``: the same with K a whole
    number of activation groups."""
    return gathered(w) and w.k_dim % w.group_size == 0 and w.bits in (4, 8)


def grouped_int8(w) -> bool:
    """The reference's ``gmm_pallas.gmm_a8_supported``: the grouped form
    quantizes the rows (K7a) where ``moe_prefill(activation="int8")`` is
    asked for and both stacks are int4 / int8 with K a whole number of
    groups, of any size."""
    return isinstance(w, QTensor) and w.bits in (4, 8) and w.k_dim % w.group_size == 0


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
