"""Gated DeltaNet (hybrid linear attention) in plain PyTorch.

The port of ``krasis_tpu/ops/deltanet.py``, which has no Pallas kernel
(it is XLA code), so nothing here is a hand-written kernel either:

* fused QKVZ / BA projections un-interleaved per key-head group
  (``fix_qkvz_ordering``);
* causal depthwise conv (kernel 4, no bias) + SiLU over concat(q, k, v);
* L2-normalised q/k (eps 1e-6), query scaled by dk^-0.5;
* recurrent state S[h, dk, dv]: S ← S·e^g + k⊗((v − S᙭k)·β), o = S᙭q;
* the chunked parallel prefill form (chunk 64) with two unit-lower-
  triangular solves per chunk, scanned across chunks.

All state math is float32 (TF32 is off, ``device.set_exact_matmul_flags``).
``fast=True`` rounds the operands of the large products to bf16 exactly
where the reference's ``mm_cast`` does and accumulates in f32; decay,
solves and state stay f32.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F


class DeltaNetDims(NamedTuple):
    num_k_heads: int
    num_v_heads: int
    head_k_dim: int
    head_v_dim: int
    conv_kernel: int

    @property
    def key_dim(self) -> int:
        return self.num_k_heads * self.head_k_dim

    @property
    def value_dim(self) -> int:
        return self.num_v_heads * self.head_v_dim

    @property
    def conv_dim(self) -> int:
        return 2 * self.key_dim + self.value_dim


def fix_qkvz_ordering(qkvz: torch.Tensor, ba: torch.Tensor, dims: DeltaNetDims):
    """Per key-head group the layout is [q(dk), k(dk), v(r·dv), z(r·dv)] with
    r = num_v_heads / num_k_heads; ba is [b(r), a(r)] per group.
    Returns q, k [B,S,Hk,dk]; v, z [B,S,Hv,dv]; b, a [B,S,Hv]."""
    B, S, _ = qkvz.shape
    hk, hv = dims.num_k_heads, dims.num_v_heads
    dk, dv = dims.head_k_dim, dims.head_v_dim
    r = hv // hk
    grouped = qkvz.reshape(B, S, hk, 2 * dk + 2 * r * dv)
    q = grouped[..., :dk]
    k = grouped[..., dk:2 * dk]
    v = grouped[..., 2 * dk:2 * dk + r * dv].reshape(B, S, hv, dv)
    z = grouped[..., 2 * dk + r * dv:].reshape(B, S, hv, dv)
    ba_g = ba.reshape(B, S, hk, 2 * r)
    b = ba_g[..., :r].reshape(B, S, hv)
    a = ba_g[..., r:].reshape(B, S, hv)
    return q, k, v, z, b, a


def causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                conv_state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d + SiLU. x [B,S,C], conv_w [C,K], conv_state
    [B,K-1,C] (the previous inputs, zeros at the start).
    Returns (y [B,S,C] in x.dtype, the last K-1 inputs)."""
    S = x.shape[1]
    K = conv_w.shape[-1]
    xf = torch.cat([conv_state.to(x.dtype), x], dim=1)       # [B, S+K-1, C]
    w = conv_w.to(torch.float32)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + xf[:, j:j + S, :].to(torch.float32) * w[:, j]
    return F.silu(y).to(x.dtype), xf[:, S:, :]


def l2norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + eps)


def _prep(q, k, v, g, beta, num_v_heads: int):
    """f32, L2 norm, head repeat to the value heads, query scale."""
    q = l2norm(q.to(torch.float32))
    k = l2norm(k.to(torch.float32))
    r = num_v_heads // q.shape[2]
    if r > 1:
        q = q.repeat_interleave(r, dim=2)
        k = k.repeat_interleave(r, dim=2)
    q = q * (q.shape[-1] ** -0.5)
    return q, k, v.to(torch.float32), g.to(torch.float32), beta.to(torch.float32)


def gated_delta_rule_recurrent(q, k, v, g, beta, state):
    """Token-by-token recurrence (the decode path, and the oracle of the
    chunked form). q, k [B,S,Hk,dk]; v [B,S,Hv,dv]; g (log-decay), beta
    [B,S,Hv]; state [B,Hv,dk,dv] f32. Returns (out [B,S,Hv,dv] f32, state)."""
    q, k, v, g, beta = _prep(q, k, v, g, beta, state.shape[1])
    outs = []
    for t in range(q.shape[1]):
        q_t, k_t, v_t = q[:, t], k[:, t], v[:, t]
        state = state * torch.exp(g[:, t])[..., None, None]
        kv_mem = torch.einsum("bhkv,bhk->bhv", state, k_t)
        delta = (v_t - kv_mem) * beta[:, t][..., None]
        state = state + torch.einsum("bhk,bhv->bhkv", k_t, delta)
        outs.append(torch.einsum("bhkv,bhk->bhv", state, q_t))
    return torch.stack(outs, dim=1), state


def delta_state_update(k, v, g, beta, state):
    """The recurrence's state alone, no outputs: the speculative verify
    step's rollback (``models/model.py`` ``la_spec_commit``) replays a
    window's committed prefix onto the pre-window state. k [B,S,Hk,dk]; v
    [B,S,Hv,dv]; g, beta [B,S,Hv], 0 at masked positions; state
    [B,Hv,dk,dv] f32. The op order is ``gated_delta_rule_recurrent``'s, so a
    position with g = beta = 0 is an exact no-op (S·e^0 = S, k⊗0 = 0) and a
    row's state advances by exactly its unmasked prefix."""
    _, k, v, g, beta = _prep(k, k, v, g, beta, state.shape[1])
    for t in range(k.shape[1]):
        k_t = k[:, t]
        state = state * torch.exp(g[:, t])[..., None, None]
        kv_mem = torch.einsum("bhkv,bhk->bhv", state, k_t)
        delta = (v[:, t] - kv_mem) * beta[:, t][..., None]
        state = state + torch.einsum("bhk,bhv->bhkv", k_t, delta)
    return state


def _mm(eq: str, a: torch.Tensor, b: torch.Tensor, fast: bool) -> torch.Tensor:
    """f32 product; `fast` rounds both operands to bf16 first (exact bf16
    products, f32 accumulation: the reference's bf16-input f32-output dot)."""
    if fast:
        a = a.to(torch.bfloat16).to(torch.float32)
        b = b.to(torch.bfloat16).to(torch.float32)
    return torch.einsum(eq, a, b)


def gated_delta_rule_chunked(q, k, v, g, beta, state, chunk_size: int = 64,
                             fast: bool = False):
    """Chunked parallel form (the prefill path): matches the recurrence.
    Same arguments and results as ``gated_delta_rule_recurrent``."""
    B, S, _, _ = q.shape
    Hv = state.shape[1]
    q, k, v, g, beta = _prep(q, k, v, g, beta, Hv)
    cs = chunk_size
    pad = (-S) % cs
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        g, beta = (F.pad(t, (0, 0, 0, pad)) for t in (g, beta))
    nc = (S + pad) // cs

    def tr(t):                                               # → [B, H, nc, cs, d]
        return t.reshape(B, nc, cs, Hv, -1).permute(0, 3, 1, 2, 4)

    q_, k_, v_ = tr(q), tr(k), tr(v)
    g_ = g.reshape(B, nc, cs, Hv).permute(0, 3, 1, 2)        # [B, H, nc, cs]
    beta_ = beta.reshape(B, nc, cs, Hv).permute(0, 3, 1, 2)

    g_ = torch.cumsum(g_, dim=-1)
    idx = torch.arange(cs, device=q.device)
    low = idx[:, None] >= idx[None, :]
    strict = idx[:, None] > idx[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    # decay[i, j] = exp(g_i - g_j) for i >= j, else 0
    decay = torch.where(low, torch.exp(g_[..., :, None] - g_[..., None, :]), zero)

    k_beta = k_ * beta_[..., None]
    v_beta = v_ * beta_[..., None]
    # T = I + strict_lower((k_beta @ k^T) * decay); the in-chunk correction
    # is T^-1 applied, as two unit-lower-triangular solves
    kk = _mm("bhnik,bhnjk->bhnij", k_beta, k_, fast) * decay
    T = torch.where(strict, kk, zero) + torch.eye(cs, dtype=torch.float32, device=q.device)
    v_new_all = torch.linalg.solve_triangular(T, v_beta, upper=False, unitriangular=True)
    k_cumdecay = torch.linalg.solve_triangular(
        T, k_beta * torch.exp(g_)[..., None], upper=False, unitriangular=True)
    attn_local = _mm("bhnik,bhnjk->bhnij", q_, k_, fast) * decay

    outs = []
    for n in range(nc):
        q_i, k_i, g_i = q_[:, :, n], k_[:, :, n], g_[:, :, n]
        v_prime = _mm("bhik,bhkv->bhiv", k_cumdecay[:, :, n], state, fast)
        v_corr = v_new_all[:, :, n] - v_prime
        attn_inter = _mm("bhik,bhkv->bhiv", q_i * torch.exp(g_i)[..., None], state, fast)
        outs.append(attn_inter + _mm("bhij,bhjv->bhiv", attn_local[:, :, n], v_corr, fast))
        g_last = g_i[..., -1]
        state = state * torch.exp(g_last)[..., None, None] + _mm(
            "bhik,bhiv->bhkv", k_i * torch.exp(g_last[..., None] - g_i)[..., None],
            v_corr, fast)
    out = torch.stack(outs, dim=2)                           # [B, H, nc, cs, dv]
    out = out.permute(0, 2, 3, 1, 4).reshape(B, S + pad, Hv, -1)
    return out[:, :S], state
