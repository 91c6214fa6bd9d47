"""The port's safetensors reader and writer: every dtype of the format
round-trips bit for bit, a sharded index routes each name to its shard,
and files cross between the two packages: the port's writer read by the
reference's reader and the reference's writer read by the port's."""

import json
import os

import numpy as np
import pytest
import torch
from ml_dtypes import bfloat16, float8_e4m3fn

from krasis_tpu.utils import safetensors_io as ref
from krasis_tpu_torch.utils.safetensors_io import (DTYPES, SafetensorsFile, ShardedSafetensors,
                                                   write_safetensors)

NUMPY = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": bfloat16,
         "F8_E4M3": float8_e4m3fn, "I64": np.int64, "I32": np.int32, "I16": np.int16,
         "I8": np.int8, "U8": np.uint8, "U16": np.uint16, "U32": np.uint32, "BOOL": np.bool_}


def _random(name: str, shape, seed: int) -> np.ndarray:
    """Random bits of the dtype (bool: 0 / 1)."""
    dt = np.dtype(NUMPY[name])
    rng = np.random.default_rng(seed)
    if name == "BOOL":
        return rng.integers(0, 2, shape).astype(np.bool_)
    raw = rng.integers(0, 256, int(np.prod(shape)) * dt.itemsize, dtype=np.uint8)
    return raw.view(dt).reshape(shape)


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_dtype_round_trips_both_ways(tmp_path, name):
    a = _random(name, (3, 5), 0)
    b = _random(name, (7,), 1)
    ta = torch.from_numpy(a.view(np.uint8).copy()).view(DTYPES[name]).reshape(3, 5)
    tb = torch.from_numpy(b.view(np.uint8).copy()).view(DTYPES[name])

    ours = str(tmp_path / "port.safetensors")
    write_safetensors(ours, {"a": ta, "b": tb})
    back = SafetensorsFile(ours)
    assert back.dtype("a") == DTYPES[name] and back.shape("a") == (3, 5)
    assert _bits(back.tensor("a")) == a.tobytes() and _bits(back.tensor("b")) == b.tobytes()
    theirs = ref.SafetensorsFile(ours)                  # port writer → reference reader
    assert theirs.tensor("a").tobytes() == a.tobytes()
    assert theirs.tensor("a").dtype == np.dtype(NUMPY[name])

    refpath = str(tmp_path / "ref.safetensors")
    ref.write_safetensors(refpath, {"a": a, "b": b})    # reference writer → port reader
    mine = SafetensorsFile(refpath)
    assert mine.dtype("b") == DTYPES[name]
    assert _bits(mine.tensor("a")) == a.tobytes() and _bits(mine.tensor("b")) == b.tobytes()


def test_sharded_index_and_zero_copy(tmp_path):
    x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    y = torch.ones(5, dtype=torch.bfloat16)
    z = torch.arange(6, dtype=torch.int8)
    write_safetensors(str(tmp_path / "model-00001-of-00002.safetensors"), {"x": x, "y": y})
    write_safetensors(str(tmp_path / "model-00002-of-00002.safetensors"), {"z": z})
    with open(tmp_path / "model.safetensors.index.json", "w") as f:
        json.dump({"weight_map": {"x": "model-00001-of-00002.safetensors",
                                  "y": "model-00001-of-00002.safetensors",
                                  "z": "model-00002-of-00002.safetensors"}}, f)
    st = ShardedSafetensors(str(tmp_path))
    assert sorted(st.keys()) == ["x", "y", "z"] and "w" not in st
    assert torch.equal(st.tensor("x"), x) and torch.equal(st.tensor("y"), y)
    assert torch.equal(st.tensor("z"), z) and st.shape("x") == (3, 4)
    # the reference's reader routes the same index to the same values
    theirs = ref.ShardedSafetensors(str(tmp_path))
    np.testing.assert_array_equal(theirs.tensor("z"), z.numpy())
    # views of one shard share its mapping
    a, b = st.tensor("x"), st.tensor("x")
    assert a.untyped_storage().data_ptr() != 0 and a.data_ptr() == b.data_ptr()
    st.close()
    assert torch.equal(a, x)          # the mapping lives as long as a view does
