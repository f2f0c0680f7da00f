"""The card tests' gates (``tests/card_gates.py``) on the CPU: the SASS
reading of the tensor-core check on a canned ``cuobjdump -sass`` listing,
and the bf16 rounding-flip rule on hand-made outputs."""
import pytest
import torch

from card_gates import (BF16_FLIP_SHARE, BF16_ULP, FLOAT32_KERNELS,
                        TENSOR_CORE_KERNELS, TRUNK_ATOL, check_features,
                        check_sass, sass_mma_counts)

FFMA = ["FFMA R4, R8, R12, R4", "EXIT"]
HMMA = ["HMMA.16816.F32.BF16 R4, R8, R12, R4",
        "HGMMA.64x128x16.F32.BF16 R24, gdesc[UR4], R24", "EXIT"]


def _listing(**bodies) -> str:
    """A listing of every trunk kernel, mangled as nvcc does: the
    tensor-core ones with HMMA/HGMMA, the float32 ones with FFMA alone,
    unless ``bodies`` says otherwise (None: no such kernel)."""
    kernels = {**{n: HMMA for n in TENSOR_CORE_KERNELS},
               **{n: FFMA for n in FLOAT32_KERNELS}, **bodies}
    return "\tcode for sm_90a\n" + "\n".join(
        f"\t\tFunction : _Z{len(n)}{n}ILb1ELi2EEvPKfPf\n"
        + "\n".join(f"        /*{16 * i:04x}*/  {op} ;"
                    for i, op in enumerate(body))
        for n, body in kernels.items() if body is not None)


def test_sass_mma_counts_read_a_canned_listing():
    """Tensor-core instructions counted by function: the tensor-core
    kernels hold them and the float32 kernels none, so the check passes
    and gives the counts by kernel family."""
    assert check_sass(sass_mma_counts(_listing())) == {
        **{n: [2] for n in TENSOR_CORE_KERNELS},
        **{n: [0] for n in FLOAT32_KERNELS}}


@pytest.mark.parametrize("bodies,refusal", [
    ({"gemm_kernel": HMMA}, "gemm_kernel: some tensor-core"),
    ({"conv_bwd_mma_kernel": FFMA}, "conv_bwd_mma_kernel: no tensor-core"),
    ({"conv_fwd_kernel": None}, "no conv_fwd_kernel"),
], ids=["float32-with-hmma", "bf16-without-hmma", "missing-kernel"])
def test_check_sass_refuses(bodies, refusal):
    with pytest.raises(AssertionError, match=refusal):
        check_sass(sass_mma_counts(_listing(**bodies)))


def _bf16_pair(flips: int, n: int = 1000):
    """bf16 features ``got`` and ``want``, equal but for ``flips`` values
    one bf16 ulp apart, as a rounding that falls the other way leaves
    them."""
    want = torch.linspace(1.0, 2.0, n).bfloat16()
    got = want.clone()
    got[:flips].view(torch.int16).add_(1)     # the next bf16 value up
    return got, want


def test_flip_check_counts_one_ulp_flips_within_the_share():
    got, want = _bf16_pair(flips=10)
    assert 10 <= BF16_FLIP_SHARE * want.numel()
    assert check_features(got, want, "bf16", "features") == 10


@pytest.mark.parametrize("case", ["wrong-value", "too-many-flips",
                                  "float32-rule"])
def test_flip_check_refuses(case):
    """A value four ulps off, more one-ulp flips than BF16_FLIP_SHARE of
    the outputs, or a float32 output beyond the float32 rule: refused."""
    precision = "bf16"
    if case == "wrong-value":
        got, want = _bf16_pair(flips=1)
        got[0] = want[0] * (1 + 4 * BF16_ULP)
    elif case == "too-many-flips":
        got, want = _bf16_pair(flips=int(BF16_FLIP_SHARE * 1000) + 1)
    else:
        want, precision = torch.linspace(1.0, 2.0, 1000), "float32"
        got = want + 3 * TRUNK_ATOL
    with pytest.raises(AssertionError):
        check_features(got, want, precision, case)
