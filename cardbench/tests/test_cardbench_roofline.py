"""The operation and byte counts against hand counts at both configurations'
shapes (written out below, so a changed formula shows)."""
import json

import pytest

from cardbench import roofline
from cardbench.model_config import dims
from cardbench.tests.tiny import ROOT

H2O = dims(json.loads((ROOT / "cardbench/configs/h2o-danube-3-4b.json").read_text()))
SC2 = dims(json.loads((ROOT / "cardbench/configs/starcoder2-15b.json").read_text()))


def test_kept_pairs():
    assert roofline.kept_pairs(4608, 4096) == 4096 * 4097 // 2 + 512 * 4096 == 10_487_808
    assert roofline.kept_pairs(5, None) == 15
    assert roofline.kept_pairs(5, 2) == 1 + 2 * 4
    assert roofline.kept_pairs(3, 10) == 6


def test_h2o_pipeline_counts():
    # q, k, v, o: 3840 x 120 x (32 + 16) + 32 x 120 x 3840; SwiGLU 3 x 3840 x 10240
    assert roofline.layer_matmul_params(H2O) == 22_118_400 + 14_745_600 + 117_964_800
    # one layer's attention over 1 x 4608: 4 x 120 x 32 x 10,487,808
    assert roofline.attention_flops(H2O, 1, 4608) == 161_092_730_880
    # 2 x 4608 x (24 x 154,828,800 + 3840 x 32000) + 24 x 161,092,730,880
    assert roofline.prefill_flops(H2O, 1, 4608) == 35_378_115_379_200 + 3_866_225_541_120
    assert roofline.prefill_flops(H2O, 1, 4608) / 4608 == pytest.approx(8.5166e9, rel=1e-4)
    # flash at 1 x 4608: operation-bound, 161.09 GFLOP at 495 TFLOP/s
    assert roofline.flash_least_s(H2O, 1, 4608) == pytest.approx(161_092_730_880 / 495e12)
    # its bytes: 4 x (2 x 4608 x 32 x 120 + 2 x 4608 x 8 x 120) = 176,947,200
    assert 176_947_200 / 3.35e12 < roofline.flash_least_s(H2O, 1, 4608)


def test_starcoder2_decode_counts():
    # q, k, v, o: 6144 x 128 x (48 + 8) + 48 x 128 x 6144; MLP 2 x 6144 x 24576
    assert roofline.layer_matmul_params(SC2) == 44_040_192 + 37_748_736 + 301_989_888
    assert roofline.decode_keys(SC2, 499) == 500
    b, pos = 16, 499
    weights = 40 * (383_778_816 + 2 * 6144) + 6144 + 6144 * 49152 + 16 * 6144
    cache = 40 * 2 * 16 * 500 * 4 * 128
    assert roofline.decode_step_bytes(SC2, b, pos) == 4 * (weights + cache + 16 * 49152) + 8 * 16
    flops = 2 * 16 * (40 * 383_778_816 + 6144 * 49152) + 40 * 4 * 128 * 48 * 16 * 500
    assert roofline.decode_step_flops(SC2, b, pos) == flops
    # memory-bound: ~63.8 GB of weights and 0.66 GB of cache at 3.35 TB/s
    assert roofline.decode_step_least_s(SC2, b, pos) == pytest.approx(
        roofline.decode_step_bytes(SC2, b, pos) / 3.35e12)
    assert 0.0190 < roofline.decode_step_least_s(SC2, b, pos) < 0.0194
