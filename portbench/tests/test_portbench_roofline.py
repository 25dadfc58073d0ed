"""The frozen compose2 work function gives, at the recorded operands'
trips and 128 / 256 / 16384 lanes, each kernel's bound as the kernel
table of PERF.md printed it, and their sum, 1.659 ms at 16384."""

import pytest

from portbench import roofline as r

W = r.WIDTHS_SEC128_K128
# kernel instance -> bound ms at 128 / 256 / 16384 lanes (PERF.md, kernel table)
TABLE = {
    "K1 W=88": (0.00150, 0.00124, 0.5215), "K1 W=72": (0.00212, 0.00567, 0.00704),
    "K1 W=144": (0.00011, 0.00022, 0.01409), "K1 W=8": (0.00001, 0.00001, 0.00078),
    "K2": (0.00258, 0.00517, 0.3324), "K3": (0.00407, 0.00812, 0.5383),
    "KT": (0.00013, 0.00026, 0.01694),
    "K5m u": (0.00006, 0.00013, 0.00814), "K5m eta0*s": (0.00004, 0.00009, 0.00563),
    "K5m t2": (0.00006, 0.00011, 0.00704), "K5m a3": (0.00006, 0.00011, 0.00704),
    "K5m t": (0.00006, 0.00011, 0.00704), "K5m t1": (0.00008, 0.00016, 0.01049),
    "K5m sq": (0.00008, 0.00016, 0.01049),
    "K5d m2": (0.00006, 0.00011, 0.00704), "K5d c3": (0.00007, 0.00013, 0.00845),
    "K5d xi": (0.00003, 0.00007, 0.00423), "K5d a1g": (0.00003, 0.00007, 0.00423),
    "K4 72 #0": (0.00008, 0.00015, 0.00964), "K4 8": (0.00004, 0.00009, 0.00557),
    "K6a xi": (0.00006, 0.00011, 0.00706), "K6a m2x2": (0.00004, 0.00009, 0.00565),
    "K6a b3": (0.00009, 0.00017, 0.01115), "K6a csum": (0.00008, 0.00016, 0.01035),
    "K6b": (0.00036, 0.00072, 0.04583), "K6c": (0.00009, 0.00019, 0.01208),
    "K6d": (0.00004, 0.00008, 0.00313), "K6e": (0.00014, 0.00029, 0.01831),
}
LANES = ((128, "decrypt", 0), (256, "chain", 1), (16384, "ladder", 2))


def _printed(v: float) -> float:
    """Half a unit in the last digit the table printed."""
    s = f"{v:.6f}".rstrip("0")
    return 0.5 * 10 ** -(len(s.split(".")[1]))


@pytest.mark.parametrize("kernel", sorted(TABLE))
@pytest.mark.parametrize("lanes,path,col", LANES)
def test_kernel_bound_matches_the_table(kernel, lanes, path, col):
    got = r.compose2_bounds(lanes, W, path)[kernel]
    want = TABLE[kernel][col]
    assert abs(got - want) <= _printed(want) + 1e-9, (kernel, lanes, got, want)


def test_every_kernel_of_a_compose2_is_counted():
    got = r.compose2_bounds(128, W, "decrypt")
    assert len(got) == 4 + 3 + 7 + 4 + 4 + 4 + 4  # K1 x4, K2 K3 KT, K5m, K5d, K4, K6a, K6b-e
    assert set(TABLE) <= set(got)


def test_compose2_sums():
    assert r.compose2_bound_ms(16384, W, "ladder") == pytest.approx(1.659, abs=0.001)
    assert r.compose2_bound_ms(512, W, "decrypt") == pytest.approx(
        4 * r.compose2_bound_ms(128, W, "decrypt"), rel=1e-4)  # one (1, 288) row read once
