"""tools/sass_compare.py's kernel keys, on cu++filt's demangled names: an
instance keeps its key when parameters are appended to its kernel or a
template flag is appended with its old behavior at false, and a true flag
keeps the instance apart. No CUDA toolkit is needed."""

import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
_spec = importlib.util.spec_from_file_location("sass_compare", ROOT / "tools" / "sass_compare.py")
sass_compare = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sass_compare)


@pytest.mark.parametrize("demangled,want", [
    ("void <unnamed>::qmm_kernel<(int)1, (int)4, float>(const __nv_bfloat16 *, T3 *, int)",
     "qmm_kernel<1, 4, float>"),
    ("void <unnamed>::qmm_kernel<(int)1, (int)4, float, (bool)0>(const __nv_bfloat16 *, T3 *, "
     "int, const int *, const int *)", "qmm_kernel<1, 4, float>"),
    ("void (anonymous namespace)::w4a8_stage1_kernel<4, 128, true>((anonymous namespace)::Args)",
     "w4a8_stage1_kernel<4, 128, true>"),
    ("void <unnamed>::gmm_kernel<(int)128, (int)0>(const int *, void *)", "gmm_kernel<128, 0>"),
    ("void <unnamed>::qmm_kernel<(int)1, (int)4, float, (bool)1, (bool)0, (bool)0>(const "
     "__nv_bfloat16 *, int, float, const void *, int)", "qmm_kernel<1, 4, float, 1>"),
    ("void <unnamed>::qmm_kernel<(int)1, (int)4, __nv_bfloat16, (bool)1, (bool)0, (bool)1>("
     "const __nv_bfloat16 *)", "qmm_kernel<1, 4, __nv_bfloat16, 1, 0, 1>"),
    ("<unnamed>::gq_bf16_kernel(const __nv_bfloat16 *, const int *)", "gq_bf16_kernel"),
])
def test_key(demangled, want):
    assert sass_compare.key(demangled) == want
