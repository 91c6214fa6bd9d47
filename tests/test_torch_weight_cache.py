"""The port's weight cache against the reference's: for the same tiny
checkpoint and QuantConfig the port writes the same files byte for byte
(and an equal index) into a directory of its own, a cache hit equals the
direct load, a rewritten shard misses the cache, reads are mmap views, and
BuildLock steals a stale lock and waits for a live one
(tests/test_loader_cache.py)."""

import json
import os

import pytest
import torch

from krasis_tpu.config import ModelConfig as JaxModelConfig
from krasis_tpu.config import QuantConfig as JaxQuantConfig
from krasis_tpu.models.loader import _cache_dir as jax_cache_dir
from krasis_tpu.models.loader import load_params as jax_load_params
from krasis_tpu_torch.config import ModelConfig, QuantConfig
from krasis_tpu_torch.models.loader import _cache_dir, load_params
from krasis_tpu_torch.models.weight_cache import BuildLock, CacheReader

from torch_ckpt_util import assert_same_leaves, write_checkpoint

CASES = {"deepseek_v2": dict(expert_bits=4, group_size=32),
         "qwen3_next": dict(attention="int8"),
         "gpt_oss_mxfp4": dict(expert_bits=8), "mtp": {}}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("ckpts")


@pytest.mark.parametrize("family", sorted(CASES))
def test_cache_files_equal_reference(root, tmp_path, monkeypatch, family):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint(family, root)
    jcfg, jquant = JaxModelConfig.from_model_path(path), JaxQuantConfig(**CASES[family])
    cfg, quant = ModelConfig.from_model_path(path), QuantConfig(**CASES[family])
    jax_load_params(jcfg, jquant, use_cache=True)
    load_params(cfg, quant, use_cache=True, device="cpu")
    want, got = jax_cache_dir(jcfg, jquant), _cache_dir(cfg, quant)
    assert os.path.basename(want) == os.path.basename(got)
    assert os.path.dirname(got) == str(tmp_path / "home" / "cache_torch")
    assert os.path.dirname(want) != os.path.dirname(got)
    files = sorted(os.listdir(want))
    assert files == sorted(os.listdir(got))
    for f in files:
        with open(os.path.join(want, f), "rb") as a, open(os.path.join(got, f), "rb") as b:
            if f.endswith(".json"):
                assert json.load(a) == json.load(b)
            else:
                assert a.read() == b.read(), f


def test_hit_equals_direct_and_reads_are_views(root, tmp_path, monkeypatch):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    path = write_checkpoint("deepseek_v2", root)
    cfg, quant = ModelConfig.from_model_path(path), QuantConfig(expert_bits=4, group_size=32)
    direct = load_params(cfg, quant, use_cache=False, device="cpu")
    built = load_params(cfg, quant, use_cache=True, device="cpu")
    hit = load_params(cfg, quant, use_cache=True, device="cpu")
    assert_same_leaves(direct, built)
    assert_same_leaves(direct, hit)

    rd = CacheReader(_cache_dir(cfg, quant))
    w13 = rd.get_leaf("pattern/0/w13")            # [reps, E, H/2, 2I]
    one = w13.q[1, 2]                             # one expert of one layer, no copy
    assert one.untyped_storage().data_ptr() == w13.q.untyped_storage().data_ptr()
    layer = hit["layers"][cfg.first_k_dense_replace + 1]
    assert torch.equal(layer["w13"].q[2], one)


def test_rewritten_shard_misses(root, tmp_path, monkeypatch):
    monkeypatch.setenv("KRASIS_TPU_HOME", str(tmp_path / "home"))
    src = write_checkpoint("qwen3_moe", root)
    path = str(tmp_path / "ckpt")
    os.makedirs(path)
    for f in os.listdir(src):
        with open(os.path.join(src, f), "rb") as a, open(os.path.join(path, f), "wb") as b:
            b.write(a.read())
    cfg, quant = ModelConfig.from_model_path(path), QuantConfig()
    load_params(cfg, quant, device="cpu")
    first = _cache_dir(cfg, quant)
    assert os.path.exists(os.path.join(first, "meta.json"))
    shard = os.path.join(path, "model.safetensors")
    st = os.stat(shard)
    os.utime(shard, (st.st_atime, st.st_mtime + 10))
    assert _cache_dir(cfg, quant) != first
    load_params(cfg, quant, device="cpu")
    assert os.path.exists(os.path.join(_cache_dir(cfg, quant), "meta.json"))


def test_build_lock_stale_steal_and_wait(tmp_path):
    cache = str(tmp_path / "c")
    with open(cache + ".lock", "w") as f:    # a dead pid's lock is stolen
        f.write("999999 0.0")
    lock = BuildLock(cache)
    assert lock.acquire() == "acquired"
    # a live lock: the second locker waits until the cache is published
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, "meta.json"), "w") as f:
        f.write("{}")
    lock2 = BuildLock(cache)
    assert lock2.acquire(poll_s=0.05) == "built"
    lock.release()
    assert not os.path.exists(cache + ".lock")
