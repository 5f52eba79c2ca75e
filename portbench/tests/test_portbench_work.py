"""work.py and the dense architecture's counts (arch/dense.py) against counts
worked by hand, two shapes each."""
import json
from pathlib import Path

import pytest

from portbench import work
from portbench.arch import dense

PKG = Path(__file__).resolve().parents[1]


def _model(name):
    m = json.loads((PKG / "configs" / f"{name}.json").read_text())["model"]
    m["padded_vocab"] = -(-m["vocab_size"] // 256) * 256
    return m


GLM, MINI = _model("glm4-9b"), _model("minitron-8b")


def test_layer_and_model_params():
    # glm4: 4096*(32+2*2)*128 + 32*128*4096 + 3*4096*13696
    assert dense.layer_matmul_params(GLM) == 18_874_368 + 16_777_216 + 168_296_448
    # 2*151552*4096 embed+head, 40 layers with two norms and the QKV bias, final norm
    assert dense.param_count(GLM) == 1_241_513_984 + 40 * (203_948_032 + 8_192 + 4_608) + 4_096
    # minitron: 4096*(48+2*8)*128 + 48*128*4096 + 2*4096*16384 (relu2: no gate)
    assert dense.layer_matmul_params(MINI) == 33_554_432 + 25_165_824 + 134_217_728
    assert dense.param_count(MINI) == 2_097_152_000 + 32 * (192_937_984 + 8_192) + 4_096


def test_token_flops():
    # 2*40*203948032 + 4*40*32*128*1000 + 2*151552*4096
    assert dense.decode_flops(GLM, 1000) == 16_315_842_560 + 655_360_000 + 1_241_513_984
    # per sequence: 2*40*203948032*4 + 4*40*32*128*(4*5/2) + 2*151552*4096; two sequences
    assert dense.prefill_flops(GLM, 2, 4) == 2 * (65_263_370_240 + 6_553_600 + 1_241_513_984)
    # minitron, one token against 1: 2*32*192937984 + 4*32*48*128*1 + 2*256000*4096
    assert dense.decode_flops(MINI, 1) == 12_348_030_976 + 786_432 + 2_097_152_000


def test_decode_bytes():
    assert dense.kv_bytes_per_token(GLM) == 40 * 2 * 2 * 128 * 2 == 40 * 1024
    assert dense.kv_bytes_per_token(MINI) == 32 * 2 * 8 * 128 * 2 == 128 * 1024
    assert dense.token_cache_bytes(GLM, 99) == 100 * 40_960
    # every f32 weight but the embedding, and the 64 rows gathered from it
    assert dense.step_param_bytes(GLM, 64) == 4 * (9_399_951_360 - 151_552 * 4096) + 64 * 4096 * 4
    assert dense.step_param_bytes(MINI, 1) == 4 * (8_271_433_728 - 256_000 * 4096) + 4096 * 4


@pytest.mark.parametrize("shape, flops, nbytes", [
    # pairs 4096*4097/2 = 8390656; 4*2*32*128*pairs; 2*4096*128*(2*32+2*2)*2
    ((2, 4096, 32, 2, 128), 274_945_015_808, 142_606_336),
    # pairs 36; 4*1*4*16*36; 1*8*16*(8+2)*2
    ((1, 8, 4, 1, 16), 9_216, 2_560),
])
def test_flash_attention_work(shape, flops, nbytes):
    assert work.flash_attention_work(*shape) == (flops, nbytes)


@pytest.mark.parametrize("rows, d, flops, nbytes", [
    (64, 4096, 1_048_576, 1_048_576 + 16_384),         # 2*64*4096*2 + 4096*4
    (16_384, 4096, 268_435_456, 268_435_456 + 16_384),
])
def test_rmsnorm_work(rows, d, flops, nbytes):
    assert work.rmsnorm_work(rows, d) == (flops, nbytes)


def test_roofline_takes_the_larger_bound():
    peaks = work.PEAKS["NVIDIA H100 80GB HBM3"]
    assert work.roofline_seconds(989e12, 0, peaks) == pytest.approx(1.0)
    assert work.roofline_seconds(1.0, 3.35e12, peaks) == pytest.approx(1.0)
    flops, nbytes = work.flash_attention_work(2, 4096, 32, 2, 128)
    assert work.roofline_seconds(flops, nbytes, peaks) == pytest.approx(flops / 989e12)
