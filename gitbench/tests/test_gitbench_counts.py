"""The yardstick's arithmetic against hand counts at two shapes each."""

import pytest

from gitbench import peaks, spec

COCO = spec.config(spec.load(), "git_large_coco")


def test_kernel1_bytes_and_flops():
    # B=32 K=4 H=12 Dh=64 M=257, 13 live text rows (pos 12): memory K/V
    # 32*12*257*128*2, text K/V 32*4*12*13*128*2, q and ctx 32*4*12*64*2*2,
    # the new row read and written 32*4*12*128*2*2: 31.6 MB
    nbytes, flops = peaks.decode_attention(32, 4, 12, 64, 257, 13)
    assert nbytes == 25_264_128 + 5_111_808 + 393_216 + 786_432 == 31_555_584
    assert flops == 4 * 32 * 4 * 12 * (257 + 13) * 64
    nbytes, _ = peaks.decode_attention(32, 4, 12, 64, 1201, 5)
    assert nbytes == 32 * 12 * 1201 * 256 + 32 * 4 * 12 * 5 * 256 + 393_216 + 786_432


def test_kernel2_flops():
    nbytes, flops = peaks.flash_encoder(32, 16, 1201, 64)
    assert flops == 189_058_383_872  # 189 GFLOP: 4 * 32 * 16 * 1201^2 * 64
    assert nbytes == 4 * 32 * 16 * 1201 * 64 * 2
    _, flops = peaks.flash_prefill(32, 12, 1201, 12, 64)
    seen = 1201 * 1201 + sum(range(1202, 1214))  # text row r sees its r + 1 columns
    assert flops == 4 * 32 * 12 * seen * 64


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(3.35e12, 0, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.least_s(0, 989e12, peaks.BF16_FLOPS) == pytest.approx(1.0)
    assert peaks.least_s(3.35e9, 989e12, peaks.BF16_FLOPS) == pytest.approx(1.0)


@pytest.mark.parametrize("s,tp,steps", [(257, 1, 13), (1201, 8, 4)])
def test_model_flops_by_hand(s, tp, steps):
    w, d, v, ff, k = 1024, 768, 30522, 3072, 4
    patch = 2 * (s - 1) * 588 * w
    enc = 24 * (24 * s * w * w + 4 * s * s * w)
    proj = 2 * s * 1024 * d
    per_token = 2 * (4 * d * d + 2 * d * ff)
    attn = 4 * d * (s * s + sum(s + i + 1 for i in range(tp)))
    prefill = 6 * ((s + tp) * per_token + attn) + 2 * d * v
    decode = sum(k * (6 * (per_token + 4 * d * (s + tp + j + 1)) + 2 * d * v)
                 for j in range(steps))
    assert peaks.model_flops(COCO, s, tp, steps) == patch + enc + proj + prefill + decode
    if s == 257:  # ~0.19 TFLOP an image, the encoder most of it
        assert 0.17e12 < peaks.model_flops(COCO, s, tp, steps) < 0.21e12
