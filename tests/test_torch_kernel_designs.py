"""Which design each hand-written kernel takes, and what the port's kernels
may not call.  Runs on the CPU in well under a second.

``flash_attention`` and ``expert_matmul`` each have two designs on the
card: the tensor cores for bfloat16 ("tc") and the FMA units ("fma") for
float32, whose tolerances TF32 would break.  The expert product's
tensor-core design copies rows in 16-byte pieces, so bfloat16 with D or F
no multiple of 8 (or a pointer off a 16-byte boundary) takes the FMA
design too; flash attention's head dims are all multiples of 16, so its
design follows the dtype alone (a bfloat16 pointer off a 16-byte boundary
is refused).  ``linear_scan`` has a "ring" design (TMA copies into a
shared-memory ring), which needs rows of 16-byte multiples (D a multiple
of 4) on 16-byte boundaries, and a "direct" one for every other shape.
The wrapper picks the design from these pure functions before it
launches; the launches are counted per design in ``DESIGN_COUNTS``.

No kernel, wrapper or dispatch of the port may reach a library's kernel
for the function it implements; only the plain versions (``ref.py``) may
use PyTorch's products, and ``chip_smoke.py`` times one library call
beside each kernel as its yardstick.
"""
import re
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels._build import DESIGN_COUNTS, LAUNCH_COUNTS
from repro_torch.kernels.flash_attention import flash_attention_design
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
from repro_torch.kernels.linear_scan import linear_scan_design
from repro_torch.kernels.moe_gmm import expert_matmul_design

PKG = Path(repro_torch.__file__).resolve().parent
LIBRARY_CALLS = re.compile(
    r"scaled_dot_product_attention|torch\.bmm|torch\.matmul|torch\.compile"
    r"|cublas", re.IGNORECASE)


@pytest.mark.parametrize("dtype,D,F,aligned,design", [
    (torch.bfloat16, 1536, 512, True, "tc"),      # granite gate/up
    (torch.bfloat16, 512, 1536, True, "tc"),      # granite down
    (torch.bfloat16, 0, 8, True, "tc"),
    (torch.bfloat16, 1, 5, True, "fma"),          # rows off 16 bytes
    (torch.bfloat16, 100, 16, True, "fma"),
    (torch.bfloat16, 96, 20, True, "fma"),
    (torch.bfloat16, 96, 200, False, "fma"),      # a pointer off 16 bytes
    (torch.float32, 1536, 512, True, "fma"),      # full float32
    (torch.float16, 1536, 512, True, "fma"),
])
def test_expert_matmul_design_is_a_function_of_dtype_and_shape(
        dtype, D, F, aligned, design):
    assert expert_matmul_design(dtype, D, F, aligned) == design


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_design_follows_the_dtype(dtype):
    want = "tc" if dtype == torch.bfloat16 else "fma"
    assert [flash_attention_design(dtype, d) for d in HEAD_DIMS] == \
        [want] * len(HEAD_DIMS)
    assert flash_attention_design(dtype, 48) == "fma"    # refused anyway


@pytest.mark.parametrize("D,aligned,design", [
    (2560, True, "ring"),        # recurrentgemma-2b's lru_width
    (96, True, "ring"),
    (100, True, "ring"),         # a last tile of 4 channels
    (4, True, "ring"),           # one tile narrower than the box
    (1, True, "direct"),         # rows off 16 bytes
    (31, True, "direct"),
    (33, True, "direct"),
    (2558, True, "direct"),
    (2560, False, "direct"),     # a pointer off 16 bytes
])
def test_linear_scan_design_is_a_function_of_the_shape(D, aligned, design):
    assert linear_scan_design(D, aligned) == design


def test_design_counts_sit_beside_the_launch_counts():
    assert set(LAUNCH_COUNTS) == {"we_rounds", "linear_scan",
                                  "flash_attention", "expert_matmul"}
    assert set(DESIGN_COUNTS) == {
        *((k, d) for k in ("flash_attention", "expert_matmul")
          for d in ("tc", "fma")),
        ("linear_scan", "ring"), ("linear_scan", "direct")}


def test_no_kernel_or_dispatch_calls_a_library_kernel():
    sources = sorted([*PKG.glob("kernels/*/kernel.py"),
                      *PKG.glob("kernels/*/ops.py"), *PKG.glob("csrc/*.cu"),
                      *PKG.glob("csrc/*.cuh")])
    assert len(sources) >= 13
    for path in sources:
        hits = LIBRARY_CALLS.findall(path.read_text())
        assert not hits, (path.relative_to(PKG), hits)
