"""The port's GGUF reader and codecs against the reference's: every codec
on seeded random blocks, bit for bit; a tiny GGUF checkpoint (Qwen3-MoE
names, fused expert tensors, config from the metadata alone) gives both
packages the same configuration and the same loaded leaves."""

import dataclasses

import numpy as np
import pytest
import torch

from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.loader import load_params as jax_load_params
from krasis_tpu.utils import gguf as ref
from krasis_tpu_torch.config import ModelConfig, QuantConfig
from krasis_tpu_torch.models.loader import load_params
from krasis_tpu_torch.utils import gguf
from krasis_tpu_torch.utils.gguf_source import GgufCheckpoint

from test_gguf import write_gguf
from torch_ckpt_util import assert_same_leaves
from torch_port_util import port_params

# ggml type → byte offsets of its f16 scale fields in a block
F16_FIELDS = {ref.GGML_Q8_0: (0,), ref.GGML_Q4_0: (0,), ref.GGML_Q5_0: (0,),
              ref.GGML_Q4_K: (0, 2), ref.GGML_Q5_K: (0, 2), ref.GGML_Q6_K: (208,)}


def random_blocks(ttype: int, n_blocks: int, seed: int) -> np.ndarray:
    """Random block bytes whose f16 scales are finite (seeded)."""
    rng = np.random.default_rng(seed)
    be, bb = ref.BLOCK_INFO[ttype]
    if ttype in (ref.GGML_F32, ref.GGML_F16, ref.GGML_BF16):
        dt = {ref.GGML_F32: np.float32, ref.GGML_F16: np.float16,
              ref.GGML_BF16: ref.bfloat16}[ttype]
        return rng.standard_normal(n_blocks).astype(dt).view(np.uint8)
    raw = rng.integers(0, 256, (n_blocks, bb), dtype=np.uint8)
    for off in F16_FIELDS[ttype]:
        d = (rng.standard_normal(n_blocks) * 0.05).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(n_blocks, 2)
    return raw.reshape(-1)


@pytest.mark.parametrize("ttype", sorted(ref.TYPE_NAMES), ids=lambda t: ref.TYPE_NAMES[t])
def test_codec_bit_equal(ttype):
    be, bb = ref.BLOCK_INFO[ttype]
    data = random_blocks(ttype, 4096 // be * 4 if be > 1 else 4096, ttype)
    n = data.size // bb * be
    want = ref.dequantize_raw(data, ttype, n)
    got = gguf.dequantize_raw(torch.from_numpy(data.copy()), ttype, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert got.numpy().view(np.uint32).tobytes() == want.view(np.uint32).tobytes()


def _write_tiny_gguf(path):
    """Qwen3-MoE in llama.cpp names: every quantized type the loader meets
    on the way (Q8_0 embedding / attention / head, Q4_0 / Q5_0 / Q8_0
    experts, F32 norms and router); weights are random valid blocks."""
    H, V, I, E, L, hq, hkv, d = 64, 128, 64, 4, 2, 4, 2, 16
    rng = np.random.default_rng(0)
    tensors = []

    def add(name, shape, ttype):
        if ttype == ref.GGML_F32:
            a = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
            tensors.append((name, a, ttype, None))
            return
        be = ref.BLOCK_INFO[ttype][0]
        raw = random_blocks(ttype, int(np.prod(shape)) // be, int(rng.integers(1 << 30)))
        tensors.append((name, np.zeros(shape, np.float32), ttype, raw.tobytes()))

    add("token_embd.weight", (V, H), ref.GGML_Q8_0)
    add("output.weight", (V, H), ref.GGML_Q8_0)
    add("output_norm.weight", (H,), ref.GGML_F32)
    for i in range(L):
        for suf, shape, t in (("attn_norm.weight", (H,), ref.GGML_F32),
                              ("ffn_norm.weight", (H,), ref.GGML_F32),
                              ("attn_q.weight", (hq * d, H), ref.GGML_Q8_0),
                              ("attn_k.weight", (hkv * d, H), ref.GGML_Q8_0),
                              ("attn_v.weight", (hkv * d, H), ref.GGML_Q8_0),
                              ("attn_output.weight", (H, hq * d), ref.GGML_Q8_0),
                              ("attn_q_norm.weight", (d,), ref.GGML_F32),
                              ("attn_k_norm.weight", (d,), ref.GGML_F32),
                              ("ffn_gate_inp.weight", (E, H), ref.GGML_F32),
                              ("ffn_gate_exps.weight", (E, I, H), ref.GGML_Q4_0),
                              ("ffn_up_exps.weight", (E, I, H), ref.GGML_Q5_0),
                              ("ffn_down_exps.weight", (E, H, I), ref.GGML_Q8_0)):
            add(f"blk.{i}.{suf}", shape, t)
    write_gguf(str(path), tensors, {
        "general.architecture": "qwen3moe",
        "qwen3moe.block_count": L, "qwen3moe.embedding_length": H,
        "qwen3moe.attention.head_count": hq, "qwen3moe.attention.head_count_kv": hkv,
        "qwen3moe.attention.key_length": d,
        "qwen3moe.attention.layer_norm_rms_epsilon": 1e-6,
        "qwen3moe.feed_forward_length": I, "qwen3moe.expert_count": E,
        "qwen3moe.expert_used_count": 2, "qwen3moe.expert_feed_forward_length": I,
        "qwen3moe.expert_weights_norm": True, "qwen3moe.vocab_size": V,
        "qwen3moe.rope.freq_base": 10000.0, "qwen3moe.context_length": 4096,
    })


def test_gguf_checkpoint_config_and_leaves(tmp_path, monkeypatch):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = tmp_path / "tiny.gguf"
    _write_tiny_gguf(path)
    jcfg = JaxModelConfig.from_model_path(str(path))
    cfg = ModelConfig.from_model_path(str(path))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.model_type == "qwen3_moe" and cfg.n_routed_experts == 4

    ck = GgufCheckpoint(str(path))
    name = "model.layers.1.mlp.experts.2.up_proj.weight"
    assert name in ck and ck.shape(name) == (64, 64)
    f = ref.GgufFile(str(path))
    want = f.dequantize("blk.1.ffn_up_exps.weight")[2]
    assert ck.tensor(name).numpy().tobytes() == want.tobytes()
    assert ck.gguf.metadata == f.metadata
    ck.close()

    for use_cache in (False, True):
        want = port_params(jax_load_params(jcfg, JaxQuantConfig(), use_cache=use_cache))
        got = load_params(cfg, QuantConfig(), use_cache=use_cache, device="cpu")
        assert_same_leaves(want, got)
