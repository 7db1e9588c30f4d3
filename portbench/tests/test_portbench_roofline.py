"""``roofline.py``'s operations and bytes against counts made by hand."""
import numpy as np
import pytest

from portbench import harness, roofline


def test_streamed_moe_deepseek_decode():
    # batch 8, top-6 of 64: 48 routed rows over 34 experts
    counts = np.zeros(64, np.int64)
    counts[:14] = 2
    counts[14:34] = 1
    ops, moved = roofline.streamed_moe_call(2048, 1408, counts)
    assert counts.sum() == 48
    assert ops == 2 * 3 * 2048 * 1408 * 48
    assert moved == 34 * 3 * 2048 * 1408 * 2 + 48 * 2048 * (2 + 4)
    # bytes-bound: 34 experts' 589.5 MB at 3.35 TB/s
    t = roofline.bound_s(ops, moved)
    assert t == pytest.approx(moved / 3.35e12) and 1.7e-4 < t < 1.9e-4


def test_streamed_moe_granite_c1280():
    counts = np.full(32, 4096 * 8 // 32)
    ops, moved = roofline.streamed_moe_call(1024, 512, counts, capacity=1280)
    assert ops == 2 * 3 * 1024 * 512 * 32768
    assert moved == 32 * 3 * 1024 * 512 * 2 + 32768 * 1024 * 6
    t = roofline.bound_s(ops, moved)
    assert t == pytest.approx(ops / 989e12) and 1.0e-4 < t < 1.1e-4
    # past the capacity, choices drop and are not counted
    over = np.array([2000] + [1000] * 31)
    ops2, _ = roofline.streamed_moe_call(1024, 512, over, capacity=1280)
    assert ops2 == 6 * 1024 * 512 * (1280 + 31 * 1000)


def test_flash_granite():
    ops, moved = roofline.flash_call(2, 2048, 16, 64)
    assert ops == 4 * 64 * (2048 * 2049 // 2) * 2 * 16
    assert moved == 2 * 2 * 16 * 64 * 4 * 2048
    assert roofline.bound_s(ops, moved) == pytest.approx(ops / 989e12)


def test_whole_steps():
    ds = roofline.Shape(harness.config("deepseek-moe-16b"))
    # attention 4 d^2, router d E, two shared experts 2 x 3 d m
    per_layer = 4 * 2048 * 2048 + 2048 * 64 + 2 * 3 * 2048 * 1408
    assert ds.layer_dense_params() == per_layer
    ops, moved = roofline.decode_step(ds, [100] * 8, 0, 28 * 34, 8)
    tok = 2 * 28 * (per_layer + 6 * 3 * 2048 * 1408)
    assert ops == 8 * tok + 8 * 4 * 28 * 16 * 128 * 100 + 8 * 2 * 2048 * 102400
    assert moved == (28 * per_layer + 28 * 34 * 3 * 2048 * 1408
                     + 2048 * 102400) * 2 + 800 * 2 * 28 * 16 * 128 * 2
    g = roofline.Shape(harness.config("granite-moe-1b-a400m"))
    f = roofline.score_call_flops(g, 2, 2048)
    per_tok = 2 * 24 * (1024 * 64 * (2 * 16 + 2 * 8) + 1024 * 32
                        + 8 * 3 * 1024 * 512) + 2 * 1024 * 49155
    assert f == 4096 * per_tok + 4 * 24 * 16 * 64 * (2048 * 2049 // 2) * 2
