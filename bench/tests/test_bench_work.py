"""The work counts against shapes worked by hand."""

from bench import work


def test_cold_exact_by_hand():
    # n = 4, nt = 2, D = 1: entries cost 6; 10 ASSEMBLE entries, 8 CROSS entries
    got = work.cold_exact(4, 2, 1)
    assert got["flops"] == 10 * 6 + 64 / 3 + 2 * 16 + 8 * 6 + 2 * 2 * 4
    assert got["bytes"] == 4 * (4 + 4 + 2 + 2)


def test_cold_lowrank_by_hand():
    # n = 8, nt = 2, D = 1, m = 2: 3 K_uu, 16 K_un and 4 CROSS entries; W W^T 8 * 4; c 32; A m^3/3; 2 solves 8; mean 8
    got = work.cold_lowrank(8, 2, 1, 2)
    assert got["flops"] == (3 + 16 + 4) * 6 + 32 + 32 + 8 / 3 + 8 + 8


def test_warm_and_train_by_hand():
    # n = 4, b = 2, D = 1: 8 CROSS entries, the mean 16, L^-1 K_* 32, the variance 16 + 2
    assert work.warm_uncertainty(4, 2, 1)["flops"] == 8 * 6 + 16 + 32 + 16 + 2
    assert work.warm_uncertainty(4, 2, 1)["bytes"] == 4 * (10 + 4 + 4 + 2 + 4)
    # n = 4, D = 1: 10 entries, factor 64/3, alpha 32, K^-1 128/3, contraction 10 * 8
    assert work.train_step(4, 1)["flops"] == 60 + 64 / 3 + 32 + 128 / 3 + 80


def test_gp16k_counts_and_peaks():
    # the factor dominates: n^3 / 3 at n = 16384 is 1.466e12
    assert 1.466e12 < work.cold_exact(16384, 16384, 16)["flops"] < 1.49e12
    peaks = work.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks == {"flops_per_s": 67e12, "bytes_per_s": 3.35e12}
    assert work.peaks_for("NVIDIA A100-SXM4-80GB") is None
    # flops bound the warm request though it reads the whole factor
    w = work.warm_uncertainty(16384, 2048, 16)
    assert work.least_seconds(w, peaks) == w["flops"] / 67e12
