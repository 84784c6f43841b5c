"""The frozen counts and peaks against shapes worked by hand."""

from __future__ import annotations

import pytest

from perfbench import costs, peaks


def bound(flops, nbytes):
    """Which of the two terms of ``peaks.least_seconds`` is the larger."""
    return "bytes" if nbytes / peaks.HBM_BYTES_PER_S >= flops / peaks.FLOAT32_FLOPS \
        else "operations"


def test_peaks_are_the_h100_sxm_data_sheet():
    assert peaks.FLOAT32_FLOPS == 67e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12


def test_k1_at_10k_and_100k():
    # 8 operations and 12 B a replica-step, 12 B a step for the coefficient rows.
    assert costs.k1(10_000, 100) == (8_000_000.0, 12_000_000.0 + 1_200.0)
    assert peaks.least_seconds(*costs.k1(10_000, 100)) == pytest.approx(3.5824e-6, rel=1e-4)
    assert peaks.least_seconds(*costs.k1(100_000, 100)) == pytest.approx(35.8213e-6, rel=1e-4)
    assert bound(*costs.k1(100_000, 100)) == "bytes"


def test_k3_at_ladder_hmm():
    # R T (6 K^2 + 12 K) = 4096 * 64 * 144; bytes 4 (2 R T K + R + K^2 + K + R K^2).
    flops, nbytes = costs.k3(4096, 64, 4)
    assert flops == 4096 * 64 * 144 == 37_748_736
    assert nbytes == 4 * (2_097_152 + 4_096 + 16 + 4 + 65_536) == 8_667_216
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(2.5872e-6, rel=1e-4)
    assert bound(flops, nbytes) == "bytes"


def test_lgssm_call_reads_y_and_writes_two_marginals():
    assert costs.lgssm_call(10_000, 100) == (8_000_000.0, 12_000_000.0)


def test_hmm_fit_at_ladder_hmm_with_20_iterations():
    R, T, K, M, n = 4096, 64, 4, 8, 20
    flops, nbytes = costs.hmm_fit(R, T, K, M, n)
    # 21 passes at 144 a replica-step; 20 M-steps of R T K + R K^2.
    assert flops == 21 * 37_748_736 + 20 * (1_048_576 + 65_536) == 815_005_696
    # int64 observations read; (R,T,K) + (R,K,K) + (R,) + K^2 + K M + 1 float32 written.
    assert nbytes == 8 * 262_144 + 4 * (1_048_576 + 65_536 + 4_096 + 16 + 32 + 1) == 6_570_180
    assert bound(flops, nbytes) == "operations"
    assert peaks.least_seconds(flops, nbytes) == pytest.approx(12.164e-6, rel=1e-3)
