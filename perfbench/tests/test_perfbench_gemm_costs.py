"""The yardstick of ESM-2's linear maps (``harness/costs_gemm.py``) against
hand counts at a small shape, and the reader of ``gemm_roofline.ap_esm``."""
import types

import pytest

from perfbench.harness import common, costs, costs_gemm

CFG = {"hidden_size": 8, "intermediate_size": 32, "num_hidden_layers": 3}


def test_block_maps_are_the_six_linear_maps():
    assert costs_gemm.block_maps(CFG) == [(8, 8)] * 4 + [(32, 8), (8, 32)]


def test_map_pass_hand_count():
    # M = 10 rows, N = 6, K = 4: x 40, W 24, b 6, y 60 floats; 240 multiply-adds
    assert costs_gemm.map_pass(10, 6, 4) == (4 * (40 + 24 + 6 + 60), 2 * 240)


def test_bound_sums_every_map_of_every_block_of_each_forward():
    work = [(1, 2, 5, CFG, "float32"), (2, 1, 7, CFG, "float32")]
    want = 0.0
    for n, B, T, _, _ in work:
        M = B * T
        per_block = sum(costs.bound_s(*costs_gemm.map_pass(M, N, K), "float32")
                        for N, K in [(8, 8)] * 4 + [(32, 8), (8, 32)])
        want += n * 3 * per_block
    assert costs_gemm.gemm_bound_s(work) == pytest.approx(want)


def test_bound_at_esm2_650m_is_operations_over_165_tflops():
    cfg = {"hidden_size": 1280, "intermediate_size": 5120, "num_hidden_layers": 33}
    # 5 rows of 256 tokens: 33 blocks x 2 M (4 d^2 + 2 d f) multiply-adds, all operations-bound
    M, d, f = 1280, 1280, 5120
    ops = 33 * 2 * M * (4 * d * d + 2 * d * f)
    assert costs_gemm.gemm_bound_s([(1, 5, 256, cfg, "float32")]) == pytest.approx(ops / 165e12)


class _Trace:
    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, patterns):
        return self.seconds if "gemm_tf32x3_kernel" in patterns else 0.0


def test_reader_is_bound_over_kernel_time_and_silent_without_the_kernel():
    read = common.metric_reader("gemm_roofline.ap_esm")
    work = [(1, 5, 256, {"hidden_size": 1280, "intermediate_size": 5120,
                         "num_hidden_layers": 33}, "float32")]
    bound = costs_gemm.gemm_bound_s(work)
    ctx = types.SimpleNamespace(trace=_Trace(2 * bound), work=work)
    assert read(ctx) == pytest.approx(50.0)
    assert read(types.SimpleNamespace(trace=_Trace(0.0), work=work)) is None
    assert read(types.SimpleNamespace(trace=None, work=work)) is None
