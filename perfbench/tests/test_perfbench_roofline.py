"""The harness's operation and byte counts against values worked out by
hand from the published shapes."""

import pytest

from perfbench_testing import ROOT, H

from perfbench.roofline import counts as C
from perfbench.roofline.peaks import BF16_FLOPS, HBM_BYTES, bound_s

BENCH = H.load_benchmark(ROOT)
PHI = H.config_file(BENCH, "phi35moe-int8", ROOT)["model"]
MAMBA = H.config_file(BENCH, "mamba2-2.7b", ROOT)["model"]


def test_flash_wgmma_at_phi_prefill():
    # B=2 H=32 Hkv=8 S=2048 hd=128, causal: 4 B H hd S (S+1) / 2 flops;
    # q, o (B H S hd) and k, v (B Hkv S hd) in bf16
    flops, nbytes = C.flash_causal(2, 32, 8, 2048, 128)
    assert flops == 4 * 2 * 32 * 128 * 2048 * 2049 // 2 == 68_753_031_168
    assert nbytes == 2 * (2 * 2 * 32 * 2048 * 128 + 2 * 2 * 8 * 2048 * 128)
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(0.06952, abs=5e-6)
    assert flops / BF16_FLOPS > nbytes / HBM_BYTES      # compute bounds it


def test_ssd_scan_tc_at_mamba2_prefill():
    # b=2 s=2048 h=80 p=64 n=128, chunk 128: the bytes bound it
    flops, nbytes = C.ssd_scan(2, 2048, 80, 64, 128, 128)
    assert nbytes == 2 * (2 * 2 * 2048 * 80 * 64 + 2 * 2 * 2048 * 128) \
        + 4 * (2 * 2048 * 80 + 80) == 87_294_272
    assert flops == 2 * 80 * 16 * (4 * 128 * 64 * 128 + 128 * 129 * 64) \
        + 2 * 16 * 128 * 129 * 128
    assert bound_s(flops, nbytes) * 1e3 == pytest.approx(0.02606, abs=5e-6)


def test_decode_attention_bytes():
    # 32 slots, 32/8 heads at hd 128, 100 cached rows, bf16
    flops, nbytes = C.decode_attention(32, 32, 8, 100, 128)
    assert nbytes == 2 * (2 * 32 * 32 * 128 + 2 * 32 * 8 * 100 * 128) + 4
    assert flops == 4 * 32 * 32 * 100 * 128


def test_phi_prefill_model_flops():
    # per layer a token uses q, o (4096 x 4096), k, v (4096 x 1024), the
    # router (4096 x 16) and 2 of 16 experts (3 x 4096 x 6400); attention
    # counts the causal pairs; the unembedding only the last position
    layer = 2 * 4096 * 4096 + 2 * 4096 * 1024 + 4096 * 16 \
        + 2 * 3 * 4096 * 6400
    assert C.layer_matmul_params(PHI) == layer == 199_294_976
    want = 2 * layer * 2 * 2048 * 32 + 32 * 68_753_031_168 \
        + 2 * 4096 * 32064 * 2
    assert C.prefill_flops(PHI, 2, 2048) == want == 54_444_604_522_496


def test_mamba2_prefill_model_flops():
    # in_proj 2560 x (2 x 5120 + 2 x 128 + 80), out_proj 5120 x 2560, the
    # scan's lower triangles, the width-4 conv over 5120 + 256 channels,
    # the tied unembedding at the last position
    layer = 2560 * (2 * 5120 + 2 * 128 + 80) + 5120 * 2560
    assert C.layer_matmul_params(MAMBA) == layer == 40_181_760
    scan = 2 * 80 * 16 * (4 * 128 * 64 * 128 + 128 * 129 * 64) \
        + 2 * 16 * 128 * 129 * 128
    conv = 2 * 4 * (5120 + 256) * 2 * 2048
    want = 64 * (2 * layer * 2 * 2048 + scan + conv) + 2 * 2560 * 50288 * 2
    assert C.prefill_flops(MAMBA, 2, 2048) == want == 21_943_267_983_360


def test_roofline_shares_stay_under_100_at_the_bound():
    """A reader's share is the bound over the time: at exactly the bound
    it reads 100 %."""
    read = H.reader("flash_wgmma_roofline.prefill")
    one = bound_s(*C.flash_causal(2, 32, 8, 2048, 128)) * 1e6
    rec = {"m": PHI, "calls": 1, "batch": 2, "seq": 2048,
           "device": [("void flash_wgmma_kernel<128>", i * one, (i + 1) * one)
                      for i in range(32)],
           "launches": {"flash_attention.wgmma": 32}}
    assert read(rec) == pytest.approx(100.0)
    rec["launches"]["flash_attention.wgmma"] = 31     # the counts disagree
    with pytest.raises(H.Missing):
        read(rec)
