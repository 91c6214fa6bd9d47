"""The port's probe functions (krasis_tpu_torch/ops/probes_cuda.py, the probe
forms of ops/gmm_cuda.py, moe_prefill(tile_rows=...)) against the TPU
probes under benchmarks/ on the same seeded numpy inputs.

The TPU probes assert a TPU backend at import: they are loaded by file path
with jax.default_backend patched for the import alone and benchmarks/ on
sys.path, and their kernels run in Pallas interpret mode
(pltpu.force_tpu_interpret_mode; probe_w4a8 reads W4A8_INTERPRET at
import). Rows of grouped tiles that are not computed are undefined in the
probes (NaN in interpret mode), so only the computed tiles' rows are
compared. probe_int4_mxu builds its full-size stacks at import (about 2 GB):
it is loaded once for this file.
"""

import importlib.util
import io
import sys
from contextlib import redirect_stdout
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from krasis_tpu.ops import gmm_pallas as jgp
from krasis_tpu.quant import quantize as jquantize
from krasis_tpu.quant import random_qtensor as jrandom_qtensor
from krasis_tpu_torch.ops import gmm_cuda, moe_cuda, probes_cuda
from krasis_tpu_torch.quant import pack_int4

from torch_port_util import f32, t, tq

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmarks"


def _load(name, env=None):
    """benchmarks/<name>.py as a module, imported as if on a TPU."""
    spec = importlib.util.spec_from_file_location(f"tpu_{name}", BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    with mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            mock.patch.object(sys, "path", [str(BENCH)] + sys.path), \
            mock.patch.dict("os.environ", env or {}):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mxu():
    return _load("probe_int4_mxu")


@pytest.fixture(scope="module")
def terms():
    return _load("probe_gmm_terms")


@pytest.fixture(scope="module")
def variants():
    return _load("probe_unpack_variants")


def _small_experts(seed, E=8, H=256, I=128, bits=4):
    rng = np.random.default_rng(seed)
    w13 = jquantize(jnp.asarray(rng.standard_normal((E, H, 2 * I)) * 0.05, jnp.float32), bits, 128)
    w2 = jquantize(jnp.asarray(rng.standard_normal((E, I, H)) * 0.05, jnp.float32), bits, 128)
    return w13, w2


# --- P4-P8 (benchmarks/probe_int4_mxu.py)


def test_stream_matches_stream_once(mxu, monkeypatch):
    """P4: the column sums of the picked experts' packed bytes, exact."""
    w13, w2 = _small_experts(1)
    idx = jnp.asarray([[2, 5, 7]], jnp.int32)
    for name, value in (("w13", w13), ("w2", w2), ("idx", idx), ("H", 256), ("K_TOP", 3)):
        monkeypatch.setattr(mxu, name, value)
    with pltpu.force_tpu_interpret_mode():
        want = mxu.stream_once(None, w13, w2)
    got = probes_cuda.stream(t(w13.q), t(w2.q), t(idx), 256)
    assert got.shape == (1, 256)
    np.testing.assert_array_equal(f32(got), f32(want))


def test_dropping_a_pick_fails_the_stream_check(mxu):
    w13, w2 = _small_experts(2)
    eids = torch.tensor([2, 5, 7], dtype=torch.int32)
    full = probes_cuda.stream_plain(t(w13.q), t(w2.q), eids, 256)
    dropped = probes_cuda.stream_plain(t(w13.q), t(w2.q), eids[:2], 256)
    assert not torch.equal(full, dropped)


@pytest.mark.parametrize("mode", ["maskxor", "shift"])
def test_unpack_matches_unpack_once(mxu, monkeypatch, mode):
    """P8: one packed block unpacked by either form and column-summed, exact."""
    w13, _ = _small_experts(3)
    monkeypatch.setattr(mxu, "w13", w13)
    with pltpu.force_tpu_interpret_mode():
        want = mxu.unpack_once(mode)(None, w13, None)
    got = probes_cuda.unpack_colsum(t(w13.q[0]), mode)
    np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_int4_products_match_the_pallas_kernels(mxu, seed):
    """P5 (int4 operand as it lies) and P6 (cast to int8 first) on seeded
    values: x in [-8, 7] for P5, the whole int8 range for P6; exact."""
    rng = np.random.default_rng(seed)
    w = rng.integers(-8, 8, (128, 256)).astype(np.int8)
    q = pack_int4(torch.from_numpy(w))
    for kernel, port, lo in ((mxu._int4_pallas_kernel, probes_cuda.int4_dot_native, -8),
                             (mxu._int4_pallas_cast_kernel, probes_cuda.int4_dot, -128)):
        x = rng.integers(lo, -lo, (8, 128)).astype(np.int8)
        with pltpu.force_tpu_interpret_mode():
            want = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((8, 256), jnp.int32))(
                jnp.asarray(x), jnp.asarray(w, jnp.int4))
        got = port(torch.from_numpy(x), q)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_int4_products_on_the_probes_ones(mxu):
    """The probe's own all-ones calls print 128; so do the port's."""
    out = io.StringIO()
    with redirect_stdout(out), pltpu.force_tpu_interpret_mode():
        mxu.try_int4_pallas()
        mxu.try_int4_pallas_cast()
    assert out.getvalue().count("OK -> 128") == 2
    x = torch.ones((8, 128), dtype=torch.int8)
    q = pack_int4(torch.ones((128, 256), dtype=torch.int8))
    assert int(probes_cuda.int4_dot_native(x, q)[0, 0]) == 128
    assert int(probes_cuda.int4_dot(x, q)[0, 0]) == 128


def test_int4_view_shape_is_the_bitcast_shape():
    """P7: the probe's kernel writes the shape of pltpu.bitcast(q, int4);
    that kernel does not trace under this jax (ROADMAP C), so its shape
    rule is evaluated outside a kernel."""
    for R, N in ((128, 256), (7, 40)):
        want = jax.eval_shape(lambda q: pltpu.bitcast(q, jnp.int4),
                              jax.ShapeDtypeStruct((R, N), jnp.uint8)).shape
        got = probes_cuda.int4_view_shape(torch.zeros((R, N), dtype=torch.uint8))
        assert got.tolist() == [list(want)] == [[2 * R, N]]


# --- P1 (benchmarks/probe_w4a8.py)


def test_w4a8_probe_matches_k3():
    """P1 is K3's function: the probe's moe_gathered_w4a8 (interpret) against
    the port's K3 at E 8, H 256, I 384, T 4, k 3."""
    w4a8 = _load("probe_w4a8", {"W4A8_INTERPRET": "1"})
    assert w4a8.INTERPRET
    rng = np.random.default_rng(4)
    w13, w2 = _small_experts(4, E=8, H=256, I=384)
    x = jnp.asarray(rng.standard_normal((4, 256)) * 0.5, jnp.bfloat16)
    idx = jnp.asarray(rng.integers(0, 8, (4, 3)), jnp.int32)
    wts = jnp.asarray(rng.random((4, 3)) / 3, jnp.float32)
    want = w4a8.moe_gathered_w4a8(x, w13, w2, idx, wts)
    got = moe_cuda.moe_w4a8(t(x), tq(w13), tq(w2), t(idx), t(wts))
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


# --- P2, P3 and the tile heights (benchmarks/probe_unpack_variants.py,
# probe_gmm_terms.py)


def _plan_case(seed, tm, bits, T=64, k=2, E=4, H=256, I=128):
    """A tm-row plan of seeded picks, tile-aligned rows, a random stack, and
    the JAX views of the plan."""
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, E, (T, k)).astype(np.int32))
    plan = gmm_cuda.plan_tiles(idx, E, tm)
    x = jnp.asarray(rng.standard_normal((plan.n_tiles * tm, H)) * 0.5, jnp.float32
                    ).astype(jnp.bfloat16)
    w = jrandom_qtensor(jax.random.PRNGKey(seed), (E, H, 2 * I), bits, group_size=128,
                        scale_mag=0.03)
    live = plan.tile_valid.bool().repeat_interleave(tm).numpy()
    return plan, x, w, live, (jnp.asarray(plan.tile_e.numpy()),
                              jnp.asarray(plan.tile_valid.numpy()))


@pytest.mark.parametrize("bits,mode", [(4, "copy"), (4, "nounpack"), (4, "unpackonly"),
                                       (4, "full"), (8, "unpackonly"), (8, "full")])
def test_gmm_terms_match_gmm_mode(terms, bits, mode):
    """P3: each term against the probe's gmm_mode (interpret), computed tiles
    only, 2e-2; K ≥ the lane tile, as the copy term needs."""
    plan, x, w, live, j_args = _plan_case(10 + bits, 128, bits)
    with pltpu.force_tpu_interpret_mode():
        want = terms.gmm_mode(x, w, *j_args, mode=mode)[:plan.n_tiles * 128]
    got = gmm_cuda.gmm_probe(t(x), tq(w), plan, mode)
    np.testing.assert_allclose(f32(got)[live], f32(want)[live], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tm", [128, 256, 512])
def test_v2_form_matches_gmm_v2(variants, tm):
    """P2: the shift-unpack form against the probe's gmm_v2 (interpret) and
    the base (K7's function) against gmm, at three tile heights."""
    plan, x, w, live, j_args = _plan_case(20 + tm, tm, 4)
    Mp = plan.n_tiles * tm
    with pltpu.force_tpu_interpret_mode():
        want = variants.gmm_v2(x, w, *j_args, tm=tm)[:Mp]
    got = gmm_cuda.gmm_probe(t(x), tq(w), plan, "v2")
    np.testing.assert_allclose(f32(got)[live], f32(want)[live], rtol=2e-2, atol=2e-2)
    base = jgp.gmm(x, w, *j_args, interpret=True, tm=tm)[:Mp]
    np.testing.assert_allclose(f32(gmm_cuda.gmm_two_stage(t(x), None, tq(w), plan))[live],
                               f32(base)[live], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("tm", [128, 256, 512])
def test_moe_prefill_tile_rows_matches_pallas(tm):
    """moe_prefill(tile_rows=tm) against moe_prefill_pallas(tile_rows=tm),
    both on the fused path (K4 + K4 / gmm13_fused + gmm2_fused)."""
    rng = np.random.default_rng(30 + tm)
    w13, w2 = _small_experts(30 + tm, E=4, H=256, I=128)
    x = jnp.asarray(rng.standard_normal((64, 256)) * 0.5, jnp.bfloat16)
    idx = jnp.asarray(np.stack([rng.permutation(4)[:2] for _ in range(64)]), jnp.int32)
    wts = jnp.asarray(rng.random((64, 2)), jnp.float32)
    assert jgp.gmm_fused_supported(w13, w2)
    want = jgp.moe_prefill_pallas(x, w13, w2, idx, wts, interpret=True, tile_rows=tm)
    got = gmm_cuda.moe_prefill(t(x), tq(w13), tq(w2), t(idx), t(wts), tile_rows=tm)
    np.testing.assert_allclose(f32(got), f32(want), rtol=3e-2, atol=3e-2)


def test_tile_rows_choices():
    """tile_rows takes the four heights; with int8 rows K7a takes 64 and
    128 and refuses 256 (ROADMAP S-4a)."""
    w13, w2 = _small_experts(5, E=4, H=256, I=128)
    x = torch.zeros((8, 256), dtype=torch.bfloat16)
    idx = torch.zeros((8, 2), dtype=torch.int32)
    idx[:, 1] = 1
    wts = torch.ones((8, 2))
    with pytest.raises(ValueError, match="S-4a"):
        gmm_cuda.moe_prefill(x, tq(w13), tq(w2), idx, wts, activation="int8", tile_rows=256)
    out = gmm_cuda.moe_prefill(x, tq(w13), tq(w2), idx, wts, activation="int8", tile_rows=128)
    assert out.shape == (8, 256) and not out.any()
    with pytest.raises(ValueError):
        gmm_cuda.moe_prefill(x, tq(w13), tq(w2), idx, wts, tile_rows=96)
    out = gmm_cuda.moe_prefill(x, tq(w13), tq(w2), idx, wts, tile_rows=512)
    assert out.shape == (8, 256) and not out.any()
