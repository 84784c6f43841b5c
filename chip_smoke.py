"""Drive the PyTorch port's main paths once on an NVIDIA GPU: LGSSM, HMM, HGF,
the generic compiled path, the Gaussian mixtures, the vector chains, the
parallel layer and the switching and particle state-space models.

Run from the root of a checkout, with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX: its references are a float64 numpy RTS smoother,
a float64 numpy log-space forward-backward, a float64 numpy HGF, float64
numpy VB-GMMs, a float64 numpy vector Kalman filter and RTS smoother, a
float64 numpy IMM filter, and the port's own plain versions, CPU runs and
single-device runs.  Phases, each printing JSON lines:

1. ``device``: the card's name and ``nvidia-smi``'s name and power limit.
2. ``build``: builds the CUDA kernels from ``cortex_tpu_torch/csrc`` with
   ``nvcc`` (into the git-ignored ``build/``) and prints the seconds.
3. ``kernel``: the fused LGSSM sweep (K1) against its plain version on the
   card, at the main path's shapes, at every shared-memory tile, at T=3072
   (the device-memory path), at the edges of its time segments and at a
   tiny edge case.
4. ``hmm_kernel``: the HMM forward-backward kernel, without (K2) and with
   (K3) the pairwise counts, against their plain versions on the card, on
   each of its paths (the pair path: a forward and a backward thread a
   replica; a lane group a replica; a block a replica), alphas in shared and
   device memory, at the pair path's edges (every K from 1 to 9, T about the
   chains' meeting point, R past a block, the longest rows that fit).
5. ``main_path``: ``LGSSM`` at 10,000 replicas x T=100 through every
   smoother and ``ops.lgssm_smooth_fused``, against the float64 RTS; filter,
   log-evidence and NaN gaps against the port's CPU run; K1's launch count
   over this phase.
6. ``hmm_main_path``: ``HMM`` at 4,096 replicas x T=64, K=4, M=8 (the JAX
   bench's ``ladder.hmm``): ``smooth`` by scan and by the kernel and
   ``ops.hmm_forward_backward_fused`` against the float64 forward-backward;
   pooled Dirichlet VMP by the kernel against the scan; per-replica VMP with
   missing steps against the CPU; K2's and K3's launch counts over this phase.
7. ``times``: CUDA-event medians per LGSSM sweep at 10,000 and 100,000
   replicas.
8. ``hmm_times``: per-VMP-iteration times of both E-steps, and K2, K3, their
   plain versions and a matched-traffic probe at 4,096 and 65,536 replicas.
9. ``hgf_kernel``: the HGF filter kernel (K4) against its plain version on
   the card: at the main path's shape with all five tracks, none, and two in
   bf16; ragged R; one step; T the TPU kernel refused; non-default
   parameters; parameters that make every guard fire (counted in float64).
10. ``hgf_main_path``: at 65,536 replicas x T=256 (the JAX bench's
    ``ladder.hgf``), ``HGF.filter`` by scan and by the kernel and
    ``ops.hgf_filter_fused`` against the float64 HGF; ``stream_filter`` and
    ``StreamingSession`` over 8 chunks of 32 steps against the batch filter;
    ``BinaryHGF.filter`` against the CPU; K4's launch count over this phase.
11. ``hgf_times``: K4 (device and call time), its plain version, the scan
    path and a matched-traffic probe for three track sets, and the floor
    probe (one HGF step on every element at once), each beside its bound.
12. ``generic_main_path``: the generic factor-graph compiler at 10,000
    replicas (the JAX bench's ``generic_compiled``, ``generic_vmp`` and
    ``generic_structured``): the BP chain (T=100) through
    ``CompiledInference`` against the float64 RTS, the port's scan smoother,
    K1 and its own unlowered run; mean-field VMP (n=100, 4 iterations)
    against a hand-written Jacobi sweep and the port's CPU run; structured
    VMP against the CPU run and ``fixed_point``; the device kernels one call
    of each launches; the kernel counts over the phase.
13. ``generic_times``: per BP sweep beside the scan and K1 on the same data,
    per VMP iteration beside the hand-written sweep, the structured warm
    start and steady iteration, and each path's device time against its
    call time (the host's share).
14. ``gmm_main_path``: at 8,192 replicas x 256 points, D=2, K=4, 4 VMP
    iterations (the JAX bench's ``ladder.gmm``), ``GMM.fit`` and
    ``GMMFull.fit`` against float64 numpy VB-GMMs and the CPU, their free
    energies non-increasing; ``bethe_free_energy_chain`` at 10,000 x 100
    against a float64 prediction-error sum; K1-K4's counts (all 0).
15. ``gmm_times``: per VMP iteration of both models, call and device time,
    the host's share, kernels, responsibility updates per second, beside a
    matched-traffic probe and the bound.
16. ``mv_main_path``: ``MvLGSSM`` at d=4 x 4,096 and d=16 x 1,024 replicas,
    T=100 (the JAX bench's ``ladder.mv``): every smoothing method and the
    operator's matmul against a float64 RTS, ``filter`` and
    ``log_evidence`` against a float64 Kalman filter, per-component NaN gaps
    against the CPU; ``robust_lgssm_smooth`` at 10,000 x 100 and
    ``fit_mv_lgssm_ml`` against the CPU; K1-K4's counts (all 0).
17. ``mv_times``: each method's call and device time, host share and kernels
    a sweep at both shapes, ``auto_method``'s pick beside the fastest
    recursion, and ``_solve_small_logdet`` beside ``torch.linalg.solve``.

18. ``parallel_main_path`` and ``parallel_times``: the parallel layer in two
    worlds of fresh processes (``run_parallel_ranks``): one rank over NCCL,
    and four ranks that all compute on the card, joined by gloo.  Each rank
    drives, on its block of PAR_SHAPES' inputs, replica-sharded K1 with
    ``global_sum`` and ``all_converged``, time-sharded scalar smoothing with
    and without a prior, vector time-sharded and pipelined smoothing, and
    the replica-sharded HGF (K4 filter-only and with five tracks, and
    ``StreamingSession`` over 8 chunks); holds every block to the
    single-device port path and to float64 numpy; counts K1's and K4's
    launches; and times each path (call, device, collectives).
19. ``ssm_main_path`` and ``ssm_times``: ``SLDS`` at 10,000 x 100 against a
    float64 numpy IMM, ``rbpf_filter`` at 1,024 x 512 x 100 (K=1 against the
    exact Kalman evidence, K=2 against the IMM), ``particle_filter`` at 1,024
    x 1,024 x 100 against the Kalman filter within its Monte-Carlo bars;
    K1-K4's counts (all 0); each call's time, device time and kernels.

Then one line ``{"kernels": [...]}`` and, last, ``{"ok": true, "device": ...}``.
A failed check raises: the exit code is non-zero and the last line is not
printed.  Without a CUDA card it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from datetime import timedelta

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
T_MAIN = 100
R_MAIN = 10_000
R_TIMES = (10_000, 100_000)
N_RTS = 64  # replicas held against the float64 RTS
NONDEFAULT = {"A": 0.9, "Q": 0.5, "H": 2.0, "R": 0.7}
GROWING = {"A": 1.3, "Q": 0.2, "H": 0.5, "R": 1.5}  # backward gain products grow

# (n_replicas, T), parameters, rtol = atol.  1e-4 and 1e-3 are the bars of the
# TPU kernel's own tests (tests/test_pallas_kernels.py).
KERNEL_CASES = [
    ((10_000, 100), {}, 1e-4),
    ((10_001, 100), NONDEFAULT, 1e-3),  # ragged last block
    ((2_049, 200), {}, 1e-4),
    ((2_049, 500), NONDEFAULT, 1e-3),
    ((1_024, 3_072), {}, 1e-4),  # the TPU kernel's longest T: device-memory path
    ((3, 1), {}, 1e-4),
    ((100_000, 100), {}, 1e-4),
    # Segment edges: T not a multiple of the 4 segments (nor of 4: no bulk
    # copies), T below 4 (an empty segment), one replica of one step, growing
    # gain products, the 8-replica tile.
    ((10_000, 101), NONDEFAULT, 1e-3),
    ((64, 3), {}, 1e-4),
    ((1, 1), {}, 1e-4),
    ((4_001, 200), GROWING, 1e-3),
    ((257, 1_600), {}, 1e-4),
]

# The HMM path at the width of the JAX bench's ladder.hmm (bench.py:600-611).
HMM_R, HMM_T, HMM_K, HMM_M, HMM_ITERS = 4096, 64, 4, 8, 4
HMM_R_TIMES = (4096, 65_536)
N_FB = 64  # replicas held against the float64 forward-backward
# (R, T, K): the main path's shape and a ragged R; the lane-group path (16, 32
# lanes) and the general path (K=64, 200); one step; 16x the main path's
# replicas; the lane groups' and the general path's alphas through device
# memory.  Then the pair path's edges: every K from 1 to 9 (9: lane groups) at
# R=33, one past a block; T = 1, 2 and 3 about the chains' meeting point, and
# 15, 17, 33 odd; T * K off a multiple of 4 (the copies 4 bytes wide).
# phase_hmm_kernel adds, for K=4 and 8, the longest T whose rows fit the pair
# path and the next, which takes the lane groups.
HMM_KERNEL_CASES = [
    (4096, 64, 4), (4097, 64, 4), (1000, 64, 2), (257, 100, 3), (64, 64, 16),
    (40, 50, 32), (100, 30, 1), (33, 40, 64), (17, 20, 200), (5, 1, 4),
    (65_536, 64, 4), (300, 600, 4), (9, 300, 200),
    (33, 17, 1), (33, 15, 2), (33, 33, 3), (33, 17, 4), (33, 1, 5), (33, 15, 6),
    (33, 33, 7), (33, 17, 8), (33, 17, 9), (33, 2, 4), (33, 3, 4), (1000, 33, 5),
]
# (atol, rtol) of the kernels against their plain versions: a tenth of the
# bars of tests/test_pallas_kernels.py (gamma atol 1e-5, log-evidence rtol
# 1e-5), since on an H100 SXM the kernels stayed within 6e-8 (gamma) and
# 2e-7 (log-evidence, relative) at these shapes; the summed counts, T-1
# terms added in another order, at 3e-5 (there: 5e-6 relative).
HMM_TOL = {"gamma": (1e-6, 0.0), "log_evidence": (0.0, 1e-6), "xi_sum": (3e-5, 3e-5)}

# The HGF path at the width of the JAX bench's ladder.hgf (bench.py:835-876),
# streamed in 8 chunks of 32 steps.
HGF_R, HGF_T, HGF_CHUNK = 65_536, 256, 32
N_HGF = 64  # replicas held against the float64 numpy HGF
ALL5 = ("mu1", "pi1", "mu2", "pi2", "delta1")
HGF_NONDEFAULT = {"kappa": 1.4, "omega": -3.0, "theta": 0.2, "pi_u": 4.0,
                  "max_log_nu": 8.0, "min_pi2": 0.05, "max_mu2_step": 2.0}
# On u = 10 x normal every guard fires: about 15,000, 50 and 15,000 of 64 x 256
# replica-steps clip the log-volatility, floor pi2 and clip the mu2 step.
HGF_GUARDS = {"kappa": 2.0, "omega": -1.0, "theta": 0.5, "pi_u": 1000.0,
              "max_log_nu": 1.5, "min_pi2": 0.3, "max_mu2_step": 0.1}
# (R, T, tracks, bf16 tracks, parameters, data): the main path's shape with all
# five tracks, none, and two reordered in bf16; ragged R; a ragged block and
# chunk; one step; T that the TPU kernel refused for VMEM (above 2,500 with
# five tracks, above 10,837 with none); non-default parameters; every guard;
# the track write-out's edges: last chunks of 4 (float32) and 8 (bf16) steps
# in ragged blocks, and T off the 16-byte vector (u read 4 bytes at a time).
HGF_KERNEL_CASES = [
    (HGF_R, HGF_T, ALL5, False, {}, "walk"),
    (HGF_R, HGF_T, (), False, {}, "walk"),
    (HGF_R, HGF_T, ("mu2", "mu1"), True, {}, "walk"),
    (HGF_R + 1, HGF_T, ALL5, False, {}, "walk"),
    (700, 48, ALL5, False, {}, "walk"),
    (1000, 1, ALL5, False, {}, "walk"),
    (16, 4096, ALL5, False, {}, "walk"),
    (16, 16_384, (), False, {}, "walk"),
    (4096, 256, ("delta1", "pi2", "pi1"), False, HGF_NONDEFAULT, "walk"),
    (4096, 256, ALL5, True, HGF_GUARDS, "noisy"),
    (1000, 260, ALL5, False, {}, "walk"),
    (1000, 264, ("delta1", "mu1"), True, {}, "walk"),
    (999, 101, ALL5, False, HGF_NONDEFAULT, "walk"),
    (999, 100, ("pi2",), True, {}, "walk"),
]
# K4 against its plain version: finals and float32 tracks within 1e-5 (atol
# = rtol; the bar of tests/test_hgf.py), bf16 tracks within one bf16 ulp.
HGF_TOL = 1e-5
# The float32 paths against the float64 numpy HGF: atol = rtol = 1e-4 (on
# the CPU at 2,048 x 256 the plain version stayed within 7.2e-6 absolute, on
# an H100 at 65,536 x 256 within 1.7e-4 for pi1 ~ 130, 3.9e-6 for the rest);
# BinaryHGF on the card against the CPU (another exp and sigmoid): 5e-5 (on
# an H100 within 6.2e-6).
HGF_F64_TOL = 1e-4
BINARY_TOL = 5e-5
# Track sets timed, by name: (tracks, bf16 tracks).
HGF_CONFIGS = {"all five f32": (ALL5, False), "filter only": ((), False),
               "mu1 mu2 bf16": (("mu1", "mu2"), True)}

# The generic compiled path at the width of the JAX bench (bench.py:252-495,
# 940-972): 10,000 replicas, the chain and both VMP graphs n = T = 100, four
# VMP iterations; the structured path's steady iteration from 4 and 12.
GENERIC_R, GENERIC_T, GENERIC_ITERS, GENERIC_ITERS_LONG = 10_000, 100, 4, 12
N_CPU = 256  # replicas of the VMP graphs held against the port's CPU run
# Bars: the BP chain against the float64 RTS at 2e-4 (the main path's), against
# the scan smoother at 1e-5 (the same recursion in float32), the lowered plan
# against the unlowered one at rtol 1e-6, atol 1e-7 (tests/test_lowering.py);
# VMP against the hand-written sweep and the CPU at rtol 1e-4 (atol 1e-6 for
# means near 0); fixed_point against iterate at 1e-5.
GENERIC_TOL = {"rts": 2e-4, "scan": 1e-5, "lowered": (1e-7, 1e-6), "vmp": (1e-6, 1e-4),
               "fixed_point": 1e-5}

# The Gaussian-mixture path at the width of the JAX bench's ladder.gmm
# (bench.py:661): R=8,192 replicas of N=256 points in D=2, K=4 components, 4
# VMP iterations; data normal + 3 randint(0, K) per point.  The first 64
# replicas are held against the float64 numpy VB-GMMs and the port's CPU run.
GMM_R, GMM_N, GMM_D, GMM_K, GMM_ITERS = 8192, 256, 2, 4, 4
N_GMM = 64
# (atol, rtol) of the card's float32 fits against the float64 VB-GMMs and
# against the port's CPU run (another float32 rounding): 1e-4, the bar the
# CPU tests hold the port to against JAX (tests/test_torch_gmm.py).
# run_gmm_main_path, on the CPU at R=512 and on an H100 at full width, kept
# the float32 fits within 9.2e-6 of float64 on the responsibilities and
# 1.1e-6 relative on the free energy.  A free-energy step may rise by
# float32 rounding of the trace only: 1e-5 of its magnitude (on the H100 the
# smallest fall of a step was 0.015, on traces of ~1,200).
GMM_TOL = {"float64": (1e-4, 1e-4), "cpu": (1e-4, 1e-4)}
GMM_MONOTONE_RTOL = 1e-5

# The vector chains at the width of the JAX bench's ladder.mv (bench.py:
# 735-741): d=4 at 4,096 replicas and d=16 at 1,024, T=100; A=0.9 I, Q = H =
# R = P0 = I, m0 = 0, y the cumsum of normals.  64 replicas are held against
# a float64 numpy Kalman filter and RTS smoother.
MV_SHAPES, MV_T, N_MV = ((4, 4096), (16, 1024)), 100, 64
# (atol = rtol) against the float64 RTS, by method: assoc 5e-3 and sqrt 1e-3
# are the bars of tests/test_chains_mv.py:64 and tests/test_sqrt_kalman.py:
# 98; scan, blocked and matmul 2e-4 (the blocked-vs-scan bar,
# tests/test_chains_mv.py:243; test_chains_mv.py:215's 1e-6 at T=30 on
# unit-scale data lies below float32 rounding of this data, |y| up to ~40).
MV_TOL = {"scan": 2e-4, "blocked": 2e-4, "assoc": 5e-3, "matmul": 2e-4, "sqrt": 1e-3}
# The filter and log evidence against the float64 filter: the bars of
# tests/test_mv_filter_evidence.py:56-58 (means 2e-3, covariances 5e-3 /
# 2e-3, evidence rtol 1e-4); card against CPU runs of the same float32
# operations (NaN gaps, robust smoother, the ML fit's loss trace): 1e-4.
# run_mv_main_path, on the CPU at 64 replicas and on an H100 at full width,
# kept every smoother within 7.6e-6 of the float64 RTS on the means and the
# evidence within 1e-7 relative.
MV_FILTER_TOL = {"mean": 2e-3, "cov": (2e-3, 5e-3), "log_evidence": 1e-4}
MV_CPU_TOL = 1e-4
MV_FIT_R, MV_FIT_STEPS = 4096, 3

# Data-sheet rates of the H100 SXM (NVIDIA's data sheet, dense, 700 W): HBM
# bytes/s and float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations of one HGF replica-step: about 35 float32 adds, multiplies and
# compares, plus one exp and five reciprocals or divisions on the special
# function unit, which issues 16 a cycle per SM against 128 float32 lanes:
# each counted as 8 float32 operations.
HGF_OPS_PER_STEP = 35 + 8 * 6


class SmokeFailure(RuntimeError):
    """A check of the smoke run failed."""


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def numpy_rts(y, A=1.0, Q=1.0, H=1.0, R=1.0, prior=None):
    """Float64 Kalman filter + RTS smoother over the rows of ``y`` (n, T),
    with the ``(mean, variance)`` prior on the first state (none by default):
    returns ``(mean, variance)``, (n, T)."""
    y = np.asarray(y, dtype=np.float64)
    n, T = y.shape
    fm = np.empty((n, T))
    fv = np.empty(T)  # the variances do not depend on the data
    if prior is None:
        fm[:, 0], fv[0] = y[:, 0] / H, R / (H * H)
    else:
        m0, P0 = prior
        K0 = P0 * H / (H * P0 * H + R)
        fm[:, 0], fv[0] = m0 + K0 * (y[:, 0] - H * m0), P0 - K0 * H * P0
    for t in range(1, T):
        pm, pv = A * fm[:, t - 1], A * A * fv[t - 1] + Q
        K = pv * H / (H * pv * H + R)
        fm[:, t] = pm + K * (y[:, t] - H * pm)
        fv[t] = pv - K * H * pv
    sm, sv = np.empty((n, T)), np.empty(T)
    sm[:, -1], sv[-1] = fm[:, -1], fv[-1]
    for t in range(T - 2, -1, -1):
        pv = A * A * fv[t] + Q
        G = fv[t] * A / pv
        sm[:, t] = fm[:, t] + G * (sm[:, t + 1] - A * fm[:, t])
        sv[t] = fv[t] + G * G * (sv[t + 1] - pv)
    return sm, np.broadcast_to(sv, (n, T))


def _host64(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def check_close(name: str, got, want, tol: float, rtol=None) -> float:
    """Require finite ``got`` with ``|got - want| <= tol + rtol |want|``
    everywhere (``rtol`` defaults to ``tol``); return the largest absolute
    error."""
    rtol = tol if rtol is None else rtol
    got, want = _host64(got), _host64(want)
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape}, expected {want.shape}")
    if not np.isfinite(got).all():
        raise SmokeFailure(f"{name}: non-finite values")
    err = np.abs(got - want)
    worst = float(err.max()) if err.size else 0.0
    if (err > tol + rtol * np.abs(want)).any():
        raise SmokeFailure(f"{name}: max abs err {worst} outside atol={tol}, rtol={rtol}")
    return worst


def check_bf16(name: str, got, want) -> float:
    """Require bfloat16 ``got`` within one bfloat16 ulp of ``want`` (of the
    same dtype) everywhere; return the largest absolute difference."""
    got, want = _host64(got.float()), _host64(want.float())
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {got.shape}, expected {want.shape}")
    if not np.isfinite(got).all():
        raise SmokeFailure(f"{name}: non-finite values")
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126))) - 7)
    err = np.abs(got - want)
    if (err > ulp).any():
        raise SmokeFailure(f"{name}: differs by more than one bfloat16 ulp")
    return float(err.max()) if err.size else 0.0


def random_walk(n: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, T)).cumsum(axis=-1).astype(np.float32)


def _logsumexp(x, axis):
    m = np.max(x, axis=axis, keepdims=True)
    return np.squeeze(m, axis) + np.log(np.sum(np.exp(x - m), axis=axis))


def numpy_hmm_smoother(log_lik, log_A, log_pi):
    """Float64 log-space forward-backward over the replicas of ``log_lik``
    (n, T, K): returns ``(gamma, log_evidence)``, (n, T, K) and (n,)."""
    ll = np.asarray(log_lik, dtype=np.float64)
    la = np.asarray(log_A, dtype=np.float64)
    n, T, K = ll.shape
    alpha = np.empty((n, T, K))
    beta = np.zeros((n, T, K))
    alpha[:, 0] = np.asarray(log_pi, dtype=np.float64) + ll[:, 0]
    for t in range(1, T):
        alpha[:, t] = ll[:, t] + _logsumexp(alpha[:, t - 1, :, None] + la, axis=1)
    for t in range(T - 2, -1, -1):
        beta[:, t] = _logsumexp(la + (ll[:, t + 1] + beta[:, t + 1])[:, None, :], axis=2)
    log_z = _logsumexp(alpha[:, -1], axis=-1)
    return np.exp(alpha + beta - log_z[:, None, None]), log_z


HGF_DEFAULTS = {"kappa": 1.0, "omega": -2.0, "theta": 0.05, "pi_u": 10.0,
                "max_log_nu": 20.0, "min_pi2": 1e-2, "max_mu2_step": 5.0}


def numpy_hgf(u, **params):
    """Float64 2-level HGF over the rows of ``u`` (n, T) from the zero state,
    with the model's guards.  Returns ``(finals, tracks, fires)``: the final
    ``(mu1, pi1, mu2, pi2)``, each (n,); a dict of the five tracks, each (n,
    T); and how many replica-steps each guard changed."""
    p = {**HGF_DEFAULTS, **params}
    u = np.asarray(u, dtype=np.float64)
    n, T = u.shape
    mu1, pi1, mu2, pi2 = np.zeros(n), np.ones(n), np.zeros(n), np.ones(n)
    tracks = {name: np.empty((n, T)) for name in ("mu1", "pi1", "mu2", "pi2", "delta1")}
    fires = {"max_log_nu": 0, "min_pi2": 0, "max_mu2_step": 0}
    for t in range(T):
        raw = p["kappa"] * mu2 + p["omega"]
        log_nu = np.clip(raw, -p["max_log_nu"], p["max_log_nu"])
        nu = np.exp(log_nu)
        pihat1 = 1.0 / (1.0 / pi1 + nu)
        pi1_new = pihat1 + p["pi_u"]
        mu1_new = mu1 + p["pi_u"] / pi1_new * (u[:, t] - mu1)
        delta1 = (1.0 / pi1_new + (mu1_new - mu1) ** 2) * pihat1 - 1.0
        pihat2 = 1.0 / (1.0 / pi2 + p["theta"])
        w1 = nu * pihat1
        raw_pi2 = pihat2 + 0.5 * p["kappa"] ** 2 * w1 * (w1 + (2.0 * w1 - 1.0) * delta1)
        pi2 = np.maximum(raw_pi2, p["min_pi2"])
        raw_step = 0.5 * p["kappa"] * (w1 / pi2) * delta1
        mu2 = mu2 + np.clip(raw_step, -p["max_mu2_step"], p["max_mu2_step"])
        mu1, pi1 = mu1_new, pi1_new
        fires["max_log_nu"] += int((raw != log_nu).sum())
        fires["min_pi2"] += int((raw_pi2 < p["min_pi2"]).sum())
        fires["max_mu2_step"] += int((np.abs(raw_step) > p["max_mu2_step"]).sum())
        for name, value in zip(tracks, (mu1, pi1, mu2, pi2, delta1)):
            tracks[name][:, t] = value
    return (mu1, pi1, mu2, pi2), tracks, fires


def hmm_inputs(R: int, T: int, K: int, seed: int):
    """Kernel inputs as the TPU kernel's tests make them: ``lik`` ~ U(0.1,
    1.1) (R, T, K), a row-stochastic ``A`` and a uniform ``pi``, float32."""
    rng = np.random.default_rng(seed)
    lik = (rng.random((R, T, K), dtype=np.float32) + np.float32(0.1))
    A = rng.random((K, K)) + 0.2
    A /= A.sum(axis=1, keepdims=True)
    return lik, A.astype(np.float32), np.full(K, 1.0 / K, dtype=np.float32)


def hmm_bound(R: int, T: int, K: int, counts: bool) -> dict:
    """The least time of K2 (``counts=False``) or K3 on R x T x K: read
    ``lik``, A and pi once, write ``gamma``, the log-evidence (and
    ``xi_sum``) once; per replica-step about 4K^2 + 9K float32 operations
    (forward and backward products, sums, divisions), 2K^2 + 3K more for
    the counts."""
    nbytes = 4 * (2 * R * T * K + R + K * K + K + (R * K * K if counts else 0))
    ops = R * T * (4 * K * K + 9 * K + ((2 * K * K + 3 * K) if counts else 0))
    return _bound(nbytes, ops)


def hgf_data(R: int, T: int, kind: str, seed: int):
    """HGF input, float32 (R, T): ``"walk"`` is cumsum(0.1 normal), as the JAX
    bench makes it; ``"noisy"`` is 10 normal, which makes the guards fire."""
    rng = np.random.default_rng(seed)
    if kind == "walk":
        return np.cumsum(0.1 * rng.normal(size=(R, T)), axis=-1).astype(np.float32)
    return (10.0 * rng.normal(size=(R, T))).astype(np.float32)


def hgf_bound(R: int, T: int, n_tracks: int, track_bytes: int) -> dict:
    """The least time of K4 on R x T: read u once, write the finals and the
    tracks once; HGF_OPS_PER_STEP operations a replica-step."""
    return _bound(4 * R * T + 16 * R + n_tracks * track_bytes * R * T, HGF_OPS_PER_STEP * R * T)


def _bound(nbytes: float, ops: float) -> dict:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def phase_device(torch) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit(phase="device", name=name, count=torch.cuda.device_count(), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda)
    return {"name": name, "nvidia_smi": smi}


def phase_build(kernels, _build) -> None:
    start = time.perf_counter()
    kernels._library()
    seconds = time.perf_counter() - start
    logs = sorted(_build.BUILD_DIR.glob("*.so.log"), key=os.path.getmtime)
    ptxas = []
    if logs:
        ptxas = [
            line.strip() for line in logs[-1].read_text().splitlines()
            if "Used" in line or "Compiling entry" in line
        ]
    emit(phase="build", seconds=seconds, build_dir=os.path.relpath(_build.BUILD_DIR, REPO),
         ptxas=ptxas)


def phase_kernel(torch, kernels) -> float:
    """The kernel against its plain version on the card; returns the largest
    absolute error over every case."""
    worst = 0.0
    for (n, T), params, tol in KERNEL_CASES:
        y = torch.from_numpy(random_walk(n, T, seed=n + T)).cuda()
        got = kernels.lgssm_smooth_fused(y, **params)
        torch.cuda.synchronize()
        want = kernels.lgssm_smooth_fused_reference(y, **params)
        torch.cuda.synchronize()
        err_mean = check_close(f"kernel mean {n}x{T}", got.mean, want.mean, tol)
        err_var = check_close(f"kernel variance {n}x{T}", got.variance, want.variance, tol)
        tile = kernels.smem_tile(T)
        emit(phase="kernel", shape=[n, T], params=params, tol=tol,
             path=f"smem tile {tile}" if tile else "device memory",
             max_abs_err_mean=err_mean, max_abs_err_variance=err_var)
        worst = max(worst, err_mean, err_var)
    return worst


def phase_hmm_kernel(torch, kernels_hmm) -> dict:
    """K2 and K3 against their plain versions on the card; returns the
    largest absolute error of each over every case."""
    worst = {"hmm_fb": 0.0, "hmm_fb_counts": 0.0}
    edges = []
    for K in (4, 8):
        T = 1
        while kernels_hmm.kernel_plan(T + 1, K)[0] == kernels_hmm.PAIR:
            T += 1
        edges += [(300, T, K), (300, T + 1, K)]
    for R, T, K in HMM_KERNEL_CASES + edges:
        lik, A, pi = (torch.from_numpy(a).cuda() for a in hmm_inputs(R, T, K, seed=R + T + K))
        got2 = kernels_hmm.hmm_forward_backward_fused(lik, A, pi)
        got3 = kernels_hmm.hmm_forward_backward_counts_fused(lik, A, pi)
        torch.cuda.synchronize()
        want = kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi)
        torch.cuda.synchronize()
        errs = {}
        for kernel, got, fields in (("hmm_fb", got2, ("gamma", "log_evidence")),
                                    ("hmm_fb_counts", got3, ("gamma", "xi_sum", "log_evidence"))):
            for field in fields:
                atol, rtol = HMM_TOL[field]
                err = check_close(f"{kernel} {field} {R}x{T}x{K}", getattr(got, field),
                                  getattr(want, field), atol, rtol)
                errs[f"{kernel}.{field}"] = err
                worst[kernel] = max(worst[kernel], err)
        group, alpha_smem = kernels_hmm.kernel_plan(T, K)
        path = ("pair, a forward and a backward thread a replica" if group == kernels_hmm.PAIR
                else f"lane group, {group} lanes a replica" if group
                else "general, a block a replica")
        emit(phase="hmm_kernel", shape=[R, T, K], path=path,
             alphas="shared memory" if alpha_smem else "device memory",
             tol=HMM_TOL, max_abs_err=errs)
    return worst


def run_main_path(torch, LGSSM, ops, device, R: int, T: int, seed: int = 0) -> list:
    """Drive the port's main path once at ``R`` replicas x ``T`` steps on
    ``device`` through its public entry points, and check every result.

    Smoothers are held against the float64 RTS on the first 64 replicas
    (2e-4, the bar of tests/test_lgssm.py; 1e-3 for assoc, whose combine
    order rounds differently).  Filter, log-evidence and the scan with NaN
    gaps are held against the same code on the CPU at 1e-5: the same float32
    recursion, apart from the rounding of ``log``.  Returns the checks.
    """
    model = LGSSM()
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    _, y = model.sample(gen, T=T, batch_shape=(R,))
    outs = {m: model.smooth(y, method=m) for m in ("scan", "matmul", "assoc")}
    outs["lgssm_smooth_fused"] = ops.lgssm_smooth_fused(y)
    filt = model.filter(y)
    evidence = model.log_evidence(y)
    gaps = torch.rand(y.shape, generator=gen, device=device) < 0.05
    gaps[:, 0] = False
    y_gaps = y.masked_fill(gaps, math.nan)
    gapped = model.smooth(y_gaps, method="scan")
    if device != "cpu":
        torch.cuda.synchronize()

    checks = []
    sm, sv = numpy_rts(y[:N_RTS].cpu().numpy())
    for name, out in outs.items():
        tol = 1e-3 if name == "assoc" else 2e-4
        if tuple(out.mean.shape) != (R, T) or not bool(torch.isfinite(out.mean).all()):
            raise SmokeFailure(f"{name}: mean not finite of shape ({R}, {T})")
        checks.append({
            "path": name, "against": "float64 RTS", "tol": tol,
            "max_abs_err_mean": check_close(f"{name} mean", out.mean[:N_RTS], sm, tol),
            "max_abs_err_variance": check_close(
                f"{name} variance", out.variance[:N_RTS], sv, tol),
        })

    cpu_model, y_cpu = LGSSM(), y.cpu()
    filt_cpu = cpu_model.filter(y_cpu)
    for name, got, want in (
        ("filter mean", filt.mean, filt_cpu.mean),
        ("filter variance", filt.variance, filt_cpu.variance),
        ("log_evidence", evidence, cpu_model.log_evidence(y_cpu)),
        ("scan with NaN gaps", gapped.mean, cpu_model.smooth(y_gaps.cpu()).mean),
    ):
        checks.append({"path": name, "against": "port on cpu", "tol": 1e-5,
                       "max_abs_err": check_close(name, got, want, 1e-5)})
    return checks


def phase_main_path(torch, LGSSM, ops, kernels) -> int:
    kernels.LAUNCHES["lgssm_smooth"] = 0
    checks = run_main_path(torch, LGSSM, ops, "cuda", R_MAIN, T_MAIN)
    launches = kernels.LAUNCHES["lgssm_smooth"]
    for check in checks:
        emit(phase="main_path", R=R_MAIN, T=T_MAIN, **check)
    emit(phase="main_path", launches={"lgssm_smooth": launches})
    if launches < 1:
        raise SmokeFailure("the main path never launched the lgssm_smooth kernel")
    return launches


def run_hmm_main_path(torch, HMM, ops, device, R: int, T: int, K: int = HMM_K,
                      M: int = HMM_M, n_iterations: int = HMM_ITERS, seed: int = 0) -> list:
    """Drive the port's HMM path once at ``R`` replicas x ``T`` steps on
    ``device`` through its public entry points, and check every result.

    Observations are ``|random walk| mod M`` (as the JAX bench makes them),
    emissions and transitions random row-stochastic, ``pi`` uniform.  The
    smoothers are held against the float64 forward-backward on the first 64
    replicas (gamma atol 1e-4, log-evidence rtol 1e-4); pooled VMP by the
    kernel against pooled VMP by the scan (rtol 1e-3, the bar of
    tests/test_hmm.py); per-replica VMP by the scan, with 5% of the steps
    missing, against the same on the CPU (rtol 1e-4).  Returns the checks.
    """
    rng = np.random.default_rng(seed)
    obs_np = np.abs(rng.normal(size=(R, T)).cumsum(axis=-1)).astype(np.int64) % M
    A = rng.random((K, K)) + 0.2
    A /= A.sum(axis=1, keepdims=True)
    B = rng.random((K, M)) + 0.2
    B /= B.sum(axis=1, keepdims=True)
    log_lik_np = np.log(B).T[obs_np].astype(np.float32)  # (R, T, K)
    log_A_np = np.log(A).astype(np.float32)
    gaps_np = np.where(rng.random((R, T)) < 0.05, -1, obs_np)

    model = HMM(K, torch.log(torch.full((K,), 1.0 / K))).to(device)
    log_lik = torch.from_numpy(log_lik_np).to(device)
    log_A = torch.from_numpy(log_A_np).to(device)
    obs = torch.from_numpy(obs_np).to(device)
    smooth = {m: model.smooth(log_lik, log_A, method=m) for m in ("scan", "fused")}
    k2 = ops.hmm_forward_backward_fused(
        torch.exp(log_lik), torch.exp(log_A), torch.exp(model.log_pi))
    fits = {m: model.fit_vmp(obs, M, n_iterations=n_iterations, pooled=True, method=m)
            for m in ("scan", "fused")}
    per_replica = model.fit_vmp(torch.from_numpy(gaps_np).to(device), M,
                                n_iterations=n_iterations)
    if device != "cpu":
        torch.cuda.synchronize()

    checks = []
    gamma_ref, log_z_ref = numpy_hmm_smoother(
        log_lik_np[:N_FB], log_A_np, np.log(np.full(K, 1.0 / K)))
    for name, gamma, log_z in (
        ("smooth scan", torch.exp(smooth["scan"].log_gamma), smooth["scan"].log_evidence),
        ("smooth fused", torch.exp(smooth["fused"].log_gamma), smooth["fused"].log_evidence),
        ("hmm_forward_backward_fused", k2.gamma, k2.log_evidence),
    ):
        if tuple(gamma.shape) != (R, T, K) or not bool(torch.isfinite(gamma).all()):
            raise SmokeFailure(f"{name}: gamma not finite of shape ({R}, {T}, {K})")
        checks.append({
            "path": name, "against": "float64 forward-backward", "atol_gamma": 1e-4,
            "rtol_log_evidence": 1e-4,
            "max_abs_err_gamma": check_close(f"{name} gamma", gamma[:N_FB], gamma_ref, 1e-4, 0.0),
            "max_abs_err_log_evidence": check_close(
                f"{name} log_evidence", log_z[:N_FB], log_z_ref, 0.0, 1e-4),
        })

    cpu_model = HMM(K, model.log_pi.cpu())
    cpu_fit = cpu_model.fit_vmp(torch.from_numpy(gaps_np), M, n_iterations=n_iterations)
    for name, got, want, tol, against in (
        ("pooled VMP fused", fits["fused"], fits["scan"], 1e-3, "pooled VMP scan"),
        ("per-replica VMP with gaps", per_replica, cpu_fit, 1e-4, "port on cpu"),
    ):
        errs = {
            "trans_alpha": check_close(f"{name} trans_alpha", got.state.trans_alpha,
                                       want.state.trans_alpha, 0.0, tol),
            "emis_alpha": check_close(f"{name} emis_alpha", got.state.emis_alpha,
                                      want.state.emis_alpha, 0.0, tol),
            "elbo": check_close(f"{name} elbo", got.elbo, want.elbo, 0.0, tol),
        }
        checks.append({"path": name, "against": against, "rtol": tol, "max_abs_err": errs})
    return checks


def phase_hmm_main_path(torch, HMM, ops, kernels) -> dict:
    for key in ("hmm_fb", "hmm_fb_counts"):
        kernels.LAUNCHES[key] = 0
    checks = run_hmm_main_path(torch, HMM, ops, "cuda", HMM_R, HMM_T)
    launches = {key: kernels.LAUNCHES[key] for key in ("hmm_fb", "hmm_fb_counts")}
    for check in checks:
        emit(phase="hmm_main_path", R=HMM_R, T=HMM_T, K=HMM_K, M=HMM_M, **check)
    emit(phase="hmm_main_path", launches=launches)
    # K3: one smooth and one per VMP iteration; K2: the op called once.
    if launches["hmm_fb_counts"] < 1 + HMM_ITERS or launches["hmm_fb"] < 1:
        raise SmokeFailure(f"the HMM main path launched its kernels too few times: {launches}")
    return launches


def median_ms(torch, fn, flush, runs: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms over ``runs`` calls, each timed by
    its own pair of CUDA events.  Before each, outside the timing, a read of
    ``flush`` (larger than L2) evicts the inputs; reading leaves no dirty
    lines whose write-back would land on the timed call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.sum()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# Names of the device kernels that each timed path launches, as the profiler
# reports them.
DEVICE_KERNELS = {
    "kernel": ("smooth_segments_kernel", "smooth_global_kernel"),
    "hmm_fb": ("fb_pair_kernel", "fb_small_kernel", "fb_general_kernel"),
    "hmm_fb_counts": ("fb_pair_kernel", "fb_small_kernel", "fb_general_kernel"),
    "probe": ("elementwise_kernel",),
}


def _device_us(torch, fn, runs: int) -> dict:
    """Device time in µs of each kernel that ``runs`` calls of ``fn`` launch,
    by name, from ``torch.profiler``'s CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    times = {}
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", 0.0) or getattr(
            avg, "self_cuda_time_total", 0.0)
        if us > 0:
            times[avg.key] = us
    return times


def device_ms(torch, fn, flush, names=None, runs: int = 25):
    """Mean device time per call of ``fn``, each call after the L2-evicting
    read, in the kernels whose names contain one of ``names`` (default: every
    kernel but the eviction's); None when the profiler records none.  Unlike
    :func:`median_ms`, it leaves out the host's time to enqueue the call."""
    fn()
    torch.cuda.synchronize()
    evicting = set(_device_us(torch, flush.sum, 1))
    for _ in range(2):  # a profile now and then holds no kernel record: one more
        total_us = 0.0
        for key, us in _device_us(torch, lambda: (flush.sum(), fn()), runs).items():
            if (any(name in key for name in names) if names else key not in evicting):
                total_us += us
        if total_us > 0:
            return total_us / runs / 1e3
    return None


def phase_times(torch, LGSSM, ops, card: str) -> dict:
    """Per-sweep times of each path; returns {R: {path: ms}}."""
    model = LGSSM()
    op = ops.lgssm_smoother_operator(T_MAIN, device="cuda")
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    paths = {
        "scan": lambda y: model.smooth(y, method="scan"),
        "matmul": lambda y: ops.lgssm_smooth_matmul(y, operator=op),
        "assoc": lambda y: model.smooth(y, method="assoc"),
        "kernel": lambda y: ops.lgssm_smooth_fused(y),
        "plain": lambda y: ops.lgssm_smooth_fused_reference(y),
        # The one PyTorch call that computes the means: the precomputed operator.
        "library": lambda y: torch.matmul(y, op[0]),
        # Matched traffic: read y once, write two (R, T) outputs (12 B/replica-step).
        "probe": lambda y: (y * 1.000001, y + 0.5),
    }
    order = list(paths) + list(reversed(paths))  # each path twice, in turns
    result = {}
    for R in R_TIMES:
        y = torch.from_numpy(random_walk(R, T_MAIN, seed=R)).cuda()
        samples = {name: [] for name in paths}
        for name in order:
            samples[name].append(median_ms(torch, lambda: paths[name](y), flush))
        result[R] = {}
        for name, pair in samples.items():
            ms = statistics.mean(pair)
            result[R][name] = ms
            emit(phase="times", R=R, T=T_MAIN, path=name, ms_per_sweep=ms,
                 ms_rounds=pair, s_per_sweep=ms / 1e3,
                 message_updates_per_s=R * (3 * T_MAIN - 2) / (ms / 1e3),
                 gb_per_s_at_12B=12 * R * T_MAIN / (ms / 1e3) / 1e9, card=card)
        for name in ("kernel", "probe", "library"):
            ms = device_ms(torch, lambda: paths[name](y), flush, DEVICE_KERNELS.get(name))
            result[R][f"{name} device"] = ms
            emit(phase="times", R=R, T=T_MAIN, path=name, timer="profiler, device time",
                 device_ms_per_sweep=ms, card=card)
    return result


def phase_hmm_times(torch, HMM, kernels_hmm, card: str) -> dict:
    """Per-VMP-iteration times of both E-steps at the main path's width, and
    per-call times of K2, K3, their plain versions and a matched-traffic
    probe; returns {R: {path: ms}}."""
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    model = HMM(HMM_K, torch.log(torch.full((HMM_K,), 1.0 / HMM_K))).to("cuda")
    rng = np.random.default_rng(1)
    walk = rng.normal(size=(HMM_R, HMM_T)).cumsum(axis=-1)
    obs = torch.from_numpy(np.abs(walk).astype(np.int64) % HMM_M).cuda()
    for method in ("scan", "fused"):
        # One iteration's time: five iterations less one (both end in the
        # same final smoothing pass), over four.
        fit_ms = {n: median_ms(torch, lambda: model.fit_vmp(
            obs, HMM_M, n_iterations=n, pooled=True, method=method), flush, runs=5, warmup=1)
            for n in (1, 5)}
        per_iter_ms = (fit_ms[5] - fit_ms[1]) / 4
        emit(phase="hmm_times", R=HMM_R, T=HMM_T, K=HMM_K, M=HMM_M, e_step=method,
             us_per_vmp_iteration=per_iter_ms * 1e3, fit_ms=fit_ms,
             message_updates_per_s=HMM_R * HMM_T * 3 / (per_iter_ms / 1e3), card=card)

    result = {}
    for R in HMM_R_TIMES:
        lik, A, pi = (torch.from_numpy(a).cuda() for a in hmm_inputs(R, HMM_T, HMM_K, seed=R))
        paths = {
            "hmm_fb": (lambda: kernels_hmm.hmm_forward_backward_fused(lik, A, pi), 25),
            "hmm_fb_counts": (
                lambda: kernels_hmm.hmm_forward_backward_counts_fused(lik, A, pi), 25),
            "hmm_fb plain": (
                lambda: kernels_hmm.hmm_forward_backward_fused_reference(lik, A, pi), 5),
            "hmm_fb_counts plain": (
                lambda: kernels_hmm.hmm_forward_backward_counts_fused_reference(lik, A, pi), 5),
            # Matched traffic: read lik once, write one (R, T, K) tensor.
            "probe": (lambda: lik * 1.000001, 25),
        }
        order = list(paths) + list(reversed(paths))  # each path twice, in turns
        samples = {name: [] for name in paths}
        for name in order:
            fn, runs = paths[name]
            samples[name].append(median_ms(torch, fn, flush, runs=runs, warmup=2))
        result[R] = {}
        for name, pair in samples.items():
            ms = statistics.mean(pair)
            result[R][name] = ms
            emit(phase="hmm_times", R=R, T=HMM_T, K=HMM_K, path=name, ms=ms, ms_rounds=pair,
                 gb_per_s_at_8K_B=8 * HMM_K * R * HMM_T / (ms / 1e3) / 1e9, card=card)
        for name in ("hmm_fb", "hmm_fb_counts", "probe"):
            ms = device_ms(torch, paths[name][0], flush, DEVICE_KERNELS[name])
            result[R][f"{name} device"] = ms
            emit(phase="hmm_times", R=R, T=HMM_T, K=HMM_K, path=name,
                 timer="profiler, device time", device_ms=ms,
                 gb_per_s_at_8K_B=8 * HMM_K * R * HMM_T / (ms / 1e3) / 1e9 if ms else None,
                 card=card)
    return result


def phase_hgf_kernel(torch, kernels_hgf) -> float:
    """K4 against its plain version on the card; returns the largest absolute
    error over every case."""
    worst = 0.0
    for R, T, tracks, bf16, params, data in HGF_KERNEL_CASES:
        u_np = hgf_data(R, T, data, seed=R + T)
        u = torch.from_numpy(u_np).cuda()
        dtype = torch.bfloat16 if bf16 else torch.float32
        kwargs = dict(params, tracks=tracks, track_dtype=dtype)
        got = kernels_hgf.hgf_filter_fused(u, **kwargs)
        torch.cuda.synchronize()
        want = kernels_hgf.hgf_filter_fused_reference(u, **kwargs)
        torch.cuda.synchronize()
        case = f"hgf_filter {R}x{T} tracks={list(tracks)} {dtype}"
        errs = {}
        for field, g, w in zip(ALL5, got[0], want[0]):
            errs[field] = check_close(f"{case} final {field}", g, w, HGF_TOL)
        for field, g, w in zip(tracks, got[1], want[1]):
            if g.dtype != dtype:
                raise SmokeFailure(f"{case}: track {field} is {g.dtype}")
            check = check_bf16 if bf16 else (lambda *a: check_close(*a, HGF_TOL))
            errs[f"track {field}"] = check(f"{case} track {field}", g, w)
        fires = numpy_hgf(u_np[:N_HGF], **params)[2]
        if params is HGF_GUARDS and not all(fires.values()):
            raise SmokeFailure(f"{case}: a guard never fired: {fires}")
        emit(phase="hgf_kernel", shape=[R, T], tracks=list(tracks), track_dtype=str(dtype),
             params=params, data=data, tol=HGF_TOL, max_abs_err=errs,
             guard_fires_first_64=fires)
        worst = max(worst, *errs.values())
    return worst


def run_hgf_main_path(torch, models, ops, parallel, device, R: int, T: int,
                      chunk: int = HGF_CHUNK, seed: int = 0) -> list:
    """Drive the port's HGF path once at ``R`` replicas x ``T`` steps on
    ``device`` through its public entry points, and check every result.

    ``HGF.filter`` by scan and by the kernel and ``ops.hgf_filter_fused`` are
    held against the float64 numpy HGF on the first 64 replicas
    (HGF_F64_TOL); ``stream_filter`` and ``StreamingSession`` over chunks of
    ``chunk`` steps from host memory against the batch scan on the same
    device (1e-5; the same float32 operations); ``BinaryHGF.filter`` on
    binary outcomes against the same on the CPU (BINARY_TOL).  Returns the
    checks.
    """
    u_np = hgf_data(R, T, "walk", seed)
    rng = np.random.default_rng(seed + 1)
    p = 1.0 / (1.0 + np.exp(-np.cumsum(0.3 * rng.normal(size=(R, T)), axis=-1)))
    outcomes = (rng.random((R, T)) < p).astype(np.float32)

    model = models.HGF()
    u = torch.from_numpy(u_np).to(device)
    runs = {f"HGF.filter {m}": model.filter(u, method=m) for m in ("scan", "fused")}
    finals, values = ops.hgf_filter_fused(u)
    runs["hgf_filter_fused"] = (finals, values)
    chunks = [np.ascontiguousarray(u_np[:, i:i + chunk]) for i in range(0, T, chunk)]

    def chunk_step(state, c):
        return model.filter(c, state=state, tracks=())

    streamed, stream_outs = parallel.stream_filter(
        chunk_step, chunks, model.init_state((R,), device=device), device=device)
    session = parallel.StreamingSession(
        chunk_step, model.init_state((R,), device=device), device=device)
    for c in chunks:
        session.push(c)
    session_final = session.flush()
    binary = models.BinaryHGF().filter(torch.from_numpy(outcomes).to(device))
    if device != "cpu":
        torch.cuda.synchronize()

    checks = []
    want_finals, want_tracks, _ = numpy_hgf(u_np[:N_HGF])
    for name, (finals, traj) in runs.items():
        if tuple(traj[0].shape) != (R, T) or not bool(torch.isfinite(finals[0]).all()):
            raise SmokeFailure(f"{name}: mu1 not finite of shape ({R}, {T})")
        errs = {field: check_close(f"{name} final {field}", g[:N_HGF], w, HGF_F64_TOL)
                for field, g, w in zip(ALL5, finals, want_finals)}
        errs.update({f"track {field}": check_close(
            f"{name} track {field}", g[:N_HGF], want_tracks[field], HGF_F64_TOL)
            for field, g in zip(ALL5, traj)})
        checks.append({"path": name, "against": "float64 numpy HGF", "tol": HGF_F64_TOL,
                       "max_abs_err": errs})

    batch = runs["HGF.filter scan"][0]
    for name, got, n_out in (("stream_filter", streamed, len(stream_outs)),
                             ("StreamingSession", session_final, len(session.outputs))):
        if n_out != len(chunks):
            raise SmokeFailure(f"{name}: {n_out} outputs for {len(chunks)} chunks")
        errs = {field: check_close(f"{name} {field}", g, w, 1e-5)
                for field, g, w in zip(ALL5, got, batch)}
        checks.append({"path": name, "against": "batch scan", "tol": 1e-5,
                       "chunks": len(chunks), "max_abs_err": errs})

    cpu_final, cpu_traj = models.BinaryHGF().filter(torch.from_numpy(outcomes))
    errs = {field: check_close(f"BinaryHGF {field}", g, w, BINARY_TOL)
            for field, g, w in zip(cpu_final._fields, binary[0], cpu_final)}
    errs.update({f"track {field}": check_close(f"BinaryHGF track {field}", g, w, BINARY_TOL)
                 for field, g, w in zip(cpu_traj._fields, binary[1], cpu_traj)})
    checks.append({"path": "BinaryHGF.filter", "against": "port on cpu", "tol": BINARY_TOL,
                   "max_abs_err": errs})
    return checks


def phase_hgf_main_path(torch, models, ops, parallel, kernels) -> int:
    kernels.LAUNCHES["hgf_filter"] = 0
    checks = run_hgf_main_path(torch, models, ops, parallel, "cuda", HGF_R, HGF_T)
    launches = kernels.LAUNCHES["hgf_filter"]
    for check in checks:
        emit(phase="hgf_main_path", R=HGF_R, T=HGF_T, **check)
    emit(phase="hgf_main_path", launches={"hgf_filter": launches})
    # One launch by HGF.filter(method="fused"), one by the op.
    if launches < 2:
        raise SmokeFailure(f"the HGF main path launched hgf_filter {launches} times, not 2")
    return launches


def phase_hgf_times(torch, models, kernels_hgf, card: str) -> dict:
    """K4, its plain version, the scan path and a matched-traffic probe, each
    at the main path's width for each track set of HGF_CONFIGS, and the floor
    probe; returns {config: {path: ms}}."""
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    R, T = HGF_R, HGF_T
    u = torch.from_numpy(hgf_data(R, T, "walk", seed=2)).cuda()
    model = models.HGF()
    # bench.py's floor probe: one HGF step on every element at once, from a
    # state made of the data (no serial dependence, no trajectory writes).
    state = models.HGFState(u, 1.0 + u * u, 0.5 * u, 1.0 + u.abs())
    floor_ms = device_ms(torch, lambda: model.step(state, u), flush, runs=5)
    floor_call_ms = median_ms(torch, lambda: model.step(state, u), flush, runs=5, warmup=1)
    emit(phase="hgf_times", R=R, T=T, path="floor probe", device_ms=floor_ms,
         ms=floor_call_ms, card=card)

    def paths(tracks, dtype):
        def probe():
            # Matched traffic: read u once, write the config's outputs once.
            if not tracks:  # amax: the eviction's sum would hide its kernel from device_ms
                return u.amax(-1)
            out = torch.empty((R, T, len(tracks)), dtype=dtype, device="cuda")
            return out.copy_(u.unsqueeze(-1).expand(R, T, len(tracks)))

        kw = dict(tracks=tracks, track_dtype=dtype)
        return {
            "kernel": (lambda: kernels_hgf.hgf_filter_fused(u, **kw), 25, 3),
            "plain": (lambda: kernels_hgf.hgf_filter_fused_reference(u, **kw), 3, 1),
            "scan": (lambda: model.filter(u, tracks=tracks), 3, 1),
            "probe": (probe, 25, 3),
        }

    result = {"floor probe device": floor_ms, "floor probe": floor_call_ms}
    for config, (tracks, bf16) in HGF_CONFIGS.items():
        dtype = torch.bfloat16 if bf16 else torch.float32
        timed = paths(tracks, dtype)
        order = list(timed) + list(reversed(timed))  # each path twice, in turns
        samples = {name: [] for name in timed}
        for name in order:
            fn, runs, warmup = timed[name]
            samples[name].append(median_ms(torch, fn, flush, runs=runs, warmup=warmup))
        ms = {name: statistics.mean(pair) for name, pair in samples.items()}
        for name in ("kernel", "probe"):
            ms[f"{name} device"] = device_ms(
                torch, timed[name][0], flush, ("hgf_filter_kernel",) if name == "kernel" else None)
        bound = hgf_bound(R, T, len(tracks), 2 if bf16 else 4)
        for name, value in ms.items():
            emit(phase="hgf_times", R=R, T=T, config=config, path=name, ms=value,
                 ms_rounds=samples.get(name), obs_per_s=R * T / (value / 1e3) if value else None,
                 **bound, card=card)
        result[config] = ms
    return result


def _broadcast_state(tree, base_state, y_pos, initials, data):
    """The VMP graphs' compile-time state at ``data.shape[0]`` replicas: the
    frozen ``y`` marginals are the columns of ``data`` (R, n), every other
    leaf is broadcast to (R,)."""
    R = data.shape[0]
    state = []
    for s, v in zip(initials, base_state):
        if id(s) in y_pos:
            state.append(data[:, y_pos[id(s)]])
        else:
            state.append(tree.tree_map(lambda a: a.expand((R,) + tuple(a.shape)), v))
    return state


def handwritten_mean_field(torch, data, n_iterations: int):
    """The JAX bench's hand-written Jacobi sweep of the mean-field SSM
    (bench.py:347-377) in torch: all messages from the previous sweep's
    marginals, then all marginals.  Returns ``(E[tau_ss], E[tau_obs], the
    state means)``, (R,), (R,), (R, n)."""
    F = torch.nn.functional
    R, n = data.shape
    qm, qv = torch.zeros_like(data), torch.ones_like(data)
    qss = torch.ones(R, dtype=data.dtype, device=data.device)
    qobs = torch.ones_like(qss)
    ones = torch.ones_like(data[:, 1:])
    has_l, has_r = F.pad(ones, (1, 0)), F.pad(ones, (0, 1))
    for _ in range(n_iterations):
        lik_prec, trans = qobs[:, None], qss[:, None]
        prec = lik_prec + trans * (has_l + has_r)
        wmean = (lik_prec * data + trans * F.pad(qm[:, :-1], (1, 0))
                 + trans * F.pad(qm[:, 1:], (0, 1)))
        qm_new, qv_new = wmean / prec, 1.0 / prec
        rate_obs = 0.5 * (qv + (data - qm) ** 2)
        qobs_new = (1.5 * n - (n - 1.0)) / torch.sum(rate_obs, dim=1)
        rate_ss = 0.5 * (qv[:, :-1] + qv[:, 1:] + (qm[:, :-1] - qm[:, 1:]) ** 2)
        qss_new = (1.5 * (n - 1.0) - (n - 2.0)) / torch.sum(rate_ss, dim=1)
        qm, qv, qss, qobs = qm_new, qv_new, qss_new, qobs_new
    return qss, qobs, qm


class GenericPaths:
    """The three generic compiled paths at ``R`` replicas on ``device``, each
    a call a user would make: the BP chain (``bp(y)``, y (R, T)), mean-field
    VMP and structured VMP (``vmp(data, iters)`` and ``structured(data,
    iters)``, data (R, n)), each returning the quantities it is checked on."""

    def __init__(self, torch, device, T: int, n: int, lower: bool = True):
        from cortex_tpu_torch.compile import CompiledInference, dep_role_key, smart_stack
        from cortex_tpu_torch.models import (
            LGSSMChainBatched, MeanFieldSSMBatched, StructuredSSMBatched, make_chain_graph,
            make_mean_field_ssm_graph, make_structured_ssm_graph)
        from cortex_tpu_torch.utils import tree

        self.torch, self.device, self.tree, self.smart_stack = torch, device, tree, smart_stack
        engine, self.x, y, _ = make_chain_graph(T)
        self.chain = CompiledInference(engine, self.x, LGSSMChainBatched(), lower=lower)
        vid_to_obs = {v: i for i, v in enumerate(y)}
        perm = [vid_to_obs[k[1]] for k in self.chain.source_keys()]
        self.perm = None if perm == list(range(T)) else perm
        self.vmp = {}
        for name, make, rules in (("mean_field", make_mean_field_ssm_graph, MeanFieldSSMBatched),
                                  ("structured", make_structured_ssm_graph, StructuredSSMBatched)):
            engine, x, y, ss, obs = make(n, [0.0] * n, device=device)
            compiled = CompiledInference(engine, [ss, obs] + x, rules(), refine_key=dep_role_key)
            y_pos = {id(engine.get_variable_marginal(v)): i for i, v in enumerate(y)}
            self.vmp[name] = (compiled, compiled.initial_state(), y_pos, ss, obs, x)

    def bp(self, y):
        pack = y.T if self.perm is None else y.T[self.perm]
        marginals, _ = self.chain.run({}, source_pack=pack.contiguous(), packed=True)
        fam = self.smart_stack([marginals[v] for v in self.x])  # (T, R)
        return fam.mean.T, fam.variance.T

    def _state(self, name, data):
        compiled, base, y_pos, *_ = self.vmp[name]
        return _broadcast_state(self.tree, base, y_pos, compiled.schedule.initials, data)

    def _means(self, name, marginals):
        _, _, _, ss, obs, x = self.vmp[name]
        return (marginals[ss].mean, marginals[obs].mean,
                self.torch.stack([marginals[v].mean for v in x], dim=1))

    def mean_field(self, data, n_iterations: int):
        compiled = self.vmp["mean_field"][0]
        marginals, _ = compiled.iterate({}, n_iterations, self._state("mean_field", data))
        return self._means("mean_field", marginals)

    def structured(self, data, n_iterations: int, fixed_point: bool = False):
        compiled = self.vmp["structured"][0]
        state = self._state("structured", data)
        if fixed_point:
            marginals, _ = compiled.fixed_point({}, n_iterations, state, mode="steady_state")
        else:
            marginals, _ = compiled.iterate({}, n_iterations, state, steady_state=True)
        return self._means("structured", marginals)


def generic_data(R: int, T: int, seed: int = 0):
    """The chain's observations (a random walk) and the VMP graphs' (0.1 x
    a random walk, as bench.py:379 makes them), float32 (R, T)."""
    y = random_walk(R, T, seed)
    return y, 0.1 * random_walk(R, T, seed + 1)


def run_generic_main_path(torch, LGSSM, device, R: int, T: int,
                          n_iterations: int = GENERIC_ITERS, n_cpu: int = N_CPU,
                          seed: int = 0) -> list:
    """Drive the generic compiled path once at ``R`` replicas on ``device``
    through its public entry points, and check every result against the
    references named in GENERIC_TOL.  Returns the checks."""
    y_np, vmp_np = generic_data(R, T, seed)
    y, data = torch.from_numpy(y_np).to(device), torch.from_numpy(vmp_np).to(device)
    paths = GenericPaths(torch, device, T, T)
    if not (paths.chain.plan is not None and paths.chain.plan.scan_segments):
        raise SmokeFailure("the chain's schedule did not lower to scan segments")
    mean, var = paths.bp(y)
    unlowered = GenericPaths(torch, device, T, T, lower=False).bp(y)
    scan = LGSSM().smooth(y, method="scan")
    mf = paths.mean_field(data, n_iterations)
    hand = handwritten_mean_field(torch, data, n_iterations)
    st = paths.structured(data, n_iterations)
    st_fp = paths.structured(data, n_iterations, fixed_point=True)
    if device != "cpu":
        torch.cuda.synchronize()

    cpu = GenericPaths(torch, "cpu", T, T)
    data_cpu = data[:n_cpu].cpu()
    mf_cpu = cpu.mean_field(data_cpu, n_iterations)
    st_cpu = cpu.structured(data_cpu, n_iterations)

    checks = []
    if tuple(mean.shape) != (R, T):
        raise SmokeFailure(f"BP chain marginals of shape {tuple(mean.shape)}, not ({R}, {T})")
    sm, sv = numpy_rts(y_np[:N_RTS])
    lo_atol, lo_rtol = GENERIC_TOL["lowered"]
    for name, got, want, atol, rtol, against in (
        ("BP chain mean", mean[:N_RTS], sm, GENERIC_TOL["rts"], None, "float64 RTS"),
        ("BP chain variance", var[:N_RTS], sv, GENERIC_TOL["rts"], None, "float64 RTS"),
        ("BP chain mean", mean, scan.mean, GENERIC_TOL["scan"], None, "LGSSM.smooth scan"),
        ("BP chain variance", var, scan.variance, GENERIC_TOL["scan"], None,
         "LGSSM.smooth scan"),
        ("BP chain mean", mean, unlowered[0], lo_atol, lo_rtol, "lower=False"),
        ("BP chain variance", var, unlowered[1], lo_atol, lo_rtol, "lower=False"),
    ):
        checks.append({"path": name, "against": against, "atol": atol,
                       "rtol": atol if rtol is None else rtol,
                       "max_abs_err": check_close(f"{name} vs {against}", got, want, atol, rtol)})
    atol, rtol = GENERIC_TOL["vmp"]
    fp = GENERIC_TOL["fixed_point"]
    for path, got, want, against, (a, r), rows in (
        ("mean-field VMP", mf, hand, "hand-written sweep", (atol, rtol), R),
        ("mean-field VMP", mf, mf_cpu, "port on cpu", (atol, rtol), n_cpu),
        ("structured VMP", st, st_cpu, "port on cpu", (atol, rtol), n_cpu),
        ("structured VMP", st_fp, st, "iterate", (fp, fp), R),
    ):
        errs = {field: check_close(f"{path} {field} vs {against}", g[:rows], w[:rows], a, r)
                for field, g, w in zip(("E[tau_ss]", "E[tau_obs]", "x means"), got, want)}
        checks.append({"path": path, "against": against, "atol": a, "rtol": r,
                       "replicas": rows, "max_abs_err": errs})
    return checks


def _profile_once(torch, fn) -> dict:
    """The device kernels (and copies) of one call of ``fn``, their device time
    and the five that take the most of it (name cut to 100 characters, ms,
    launches), from ``torch.profiler``'s raw device records (its
    ``key_averages`` builds a Python object a record, which costs far more
    on paths of tens of thousands of kernels); kernels 0 when it recorded
    none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    by_name = {}
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != torch.autograd.DeviceType.CUDA or event.duration_ns() <= 0:
            continue
        name = event.name()
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + event.duration_ns() / 1e6, count + 1)
        if name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    top = sorted(([name[:100], ms, count] for name, (ms, count) in by_name.items()),
                 key=lambda item: -item[1])[:5]
    return {"kernels": kernels, "copies": copies,
            "device_ms": sum(ms for ms, _ in by_name.values()), "top": top}


def _count_kernels(torch, fn) -> dict:
    """:func:`_profile_once` of ``fn`` after one call to warm it up, profiled
    once more when the first profile holds no kernel record."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profile now and then holds no kernel record: one more
        counted = _profile_once(torch, fn)
        if counted["kernels"]:
            break
    return counted


def phase_generic_main_path(torch, LGSSM, ops, kernels) -> dict:
    start = time.perf_counter()
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0
    checks = run_generic_main_path(torch, LGSSM, "cuda", GENERIC_R, GENERIC_T)
    launches = dict(kernels.LAUNCHES)
    for check in checks:
        emit(phase="generic_main_path", R=GENERIC_R, T=GENERIC_T, **check)
    emit(phase="generic_main_path", launches=launches,
         note="the generic path runs eager torch operations and none of K1-K4")
    # Held against K1 too, outside the counted run.
    y_np, vmp_np = generic_data(GENERIC_R, GENERIC_T)
    y, data = torch.from_numpy(y_np).cuda(), torch.from_numpy(vmp_np).cuda()
    paths = GenericPaths(torch, "cuda", GENERIC_T, GENERIC_T)
    mean, var = paths.bp(y)
    k1 = ops.lgssm_smooth_fused(y)
    emit(phase="generic_main_path", path="BP chain", against="lgssm_smooth_fused (K1)",
         tol=GENERIC_TOL["rts"],
         max_abs_err_mean=check_close("BP chain mean vs K1", mean, k1.mean, GENERIC_TOL["rts"]),
         max_abs_err_variance=check_close("BP chain variance vs K1", var, k1.variance,
                                          GENERIC_TOL["rts"]))
    counts = {
        "BP chain sweep": _count_kernels(torch, lambda: paths.bp(y)),
        f"mean-field VMP, {GENERIC_ITERS} iterations": _count_kernels(
            torch, lambda: paths.mean_field(data, GENERIC_ITERS)),
        f"structured VMP, {GENERIC_ITERS} iterations": _count_kernels(
            torch, lambda: paths.structured(data, GENERIC_ITERS)),
    }
    for path, count in counts.items():
        emit(phase="generic_main_path", path=path, per_call=count, counter="torch.profiler")
    seconds = time.perf_counter() - start
    emit(phase="generic_main_path", seconds=seconds)
    return {"launches": launches, "counts": counts, "seconds": seconds}


def phase_generic_times(torch, LGSSM, ops, card: str) -> dict:
    """CUDA-event medians of the generic paths at the main path's width,
    beside the scan and K1 (BP) and the hand-written sweep (mean-field VMP),
    with device time against call time; returns {path: ms}."""
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    y_np, vmp_np = generic_data(GENERIC_R, GENERIC_T, seed=5)
    y, data = torch.from_numpy(y_np).cuda(), torch.from_numpy(vmp_np).cuda()
    paths = GenericPaths(torch, "cuda", GENERIC_T, GENERIC_T)
    model = LGSSM()
    it, it_long = GENERIC_ITERS, GENERIC_ITERS_LONG
    timed = {
        "BP generic": (lambda: paths.bp(y), 10),
        "BP scan": (lambda: model.smooth(y, method="scan"), 10),
        "BP kernel": (lambda: ops.lgssm_smooth_fused(y), 25),
        f"mean-field VMP compiled x{it}": (lambda: paths.mean_field(data, it), 5),
        f"mean-field VMP hand-written x{it}": (lambda: handwritten_mean_field(torch, data, it), 5),
        f"structured VMP x{it}": (lambda: paths.structured(data, it), 5),
        f"structured VMP x{it_long}": (lambda: paths.structured(data, it_long), 3),
    }
    ms = {}
    # Each pair in turns A/B/A/B, as bench.py:392-397 times the VMP paths.
    for pair in (("BP generic", "BP scan", "BP kernel"),
                 (f"mean-field VMP compiled x{it}", f"mean-field VMP hand-written x{it}"),
                 (f"structured VMP x{it}", f"structured VMP x{it_long}")):
        samples = {name: [] for name in pair}
        for name in pair + pair:
            fn, runs = timed[name]
            samples[name].append(median_ms(torch, fn, flush, runs=runs, warmup=1))
        for name, rounds in samples.items():
            ms[name] = statistics.mean(rounds)
            device = _count_kernels(torch, timed[name][0])
            emit(phase="generic_times", R=GENERIC_R, T=GENERIC_T, path=name, ms=ms[name],
                 ms_rounds=rounds, device_ms=device["device_ms"],
                 host_share=1.0 - device["device_ms"] / ms[name], kernels_per_call=device["kernels"],
                 card=card)
            ms[f"{name} device"] = device["device_ms"]
    steady = (ms[f"structured VMP x{it_long}"] - ms[f"structured VMP x{it}"]) / (it_long - it)
    warm = ms[f"structured VMP x{it}"] - (it - 1) * steady
    derived = {
        "bp_ratio_vs_scan": ms["BP generic"] / ms["BP scan"],
        "bp_ratio_vs_kernel": ms["BP generic"] / ms["BP kernel"],
        "bp_message_updates_per_s": GENERIC_R * (3 * GENERIC_T - 2) / (ms["BP generic"] / 1e3),
        "vmp_us_per_iteration_compiled": ms[f"mean-field VMP compiled x{it}"] / it * 1e3,
        "vmp_us_per_iteration_handwritten": ms[f"mean-field VMP hand-written x{it}"] / it * 1e3,
        "vmp_ratio_vs_handwritten": (ms[f"mean-field VMP compiled x{it}"]
                                     / ms[f"mean-field VMP hand-written x{it}"]),
        "structured_warm_start_us": warm * 1e3,
        "structured_steady_iteration_us": steady * 1e3,
        "structured_joint_updates_per_s": GENERIC_R * (GENERIC_T - 1) / (steady / 1e3),
    }
    emit(phase="generic_times", R=GENERIC_R, T=GENERIC_T, **derived, card=card,
         seconds=time.perf_counter() - start)
    return {**ms, **derived}


# -- The Gaussian-mixture slice (phases 14, 15) -------------------------------------


_LOG_2PI = math.log(2.0 * math.pi)


def gmm_data(R: int, N: int, D: int, K: int, seed: int = 0):
    """``normal + 3·randint(0, K)`` per point, as the JAX bench's ladder.gmm
    makes its data: float32 (R, N, D), the offset shared by a point's D
    coordinates."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, N, D)) + 3.0 * rng.integers(0, K, size=(R, N, 1))
    return x.astype(np.float32)


def _numpy_responsibilities(log_rho):
    top = log_rho.max(-1, keepdims=True)
    log_r = log_rho - top - np.log(np.exp(log_rho - top).sum(-1, keepdims=True))
    return np.exp(log_r), log_r


def numpy_vb_gmm(x, K, init_means, n_iterations, alpha0=1.0, m0=0.0, beta0=1.0, a0=1.0,
                 b0=1.0):
    """Float64 variational Bayesian GMM with diagonal Normal–Gamma components
    (Bishop §10.2): the E-step and M-step of every iteration, then the
    closed-form free energy.  ``x`` (n, N, D).  Returns ``((alpha, m, beta,
    a, b), r, free_energy)``, the trace (n, n_iterations)."""
    from scipy.special import digamma, gammaln

    x = np.asarray(x, np.float64)
    n, N, D = x.shape
    alpha = np.full((n, K), alpha0)
    m = np.array(init_means, np.float64)
    beta, a, b = (np.full((n, K, D), v) for v in (beta0, a0, b0))
    r, fes = np.zeros((n, N, K)), []
    for _ in range(n_iterations):
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        e_log_tau, e_tau = digamma(a) - np.log(b), a / b
        quad = (e_tau[:, None] * (x[:, :, None] - m[:, None]) ** 2 + 1.0 / beta[:, None]).sum(-1)
        r, log_r = _numpy_responsibilities(
            e_log_pi[:, None] + 0.5 * e_log_tau.sum(-1)[:, None] - 0.5 * D * _LOG_2PI
            - 0.5 * quad)
        Nk = r.sum(1) + 1e-10
        xbar = np.einsum("nik,nid->nkd", r, x) / Nk[..., None]
        S = np.einsum("nik,nikd->nkd", r, (x[:, :, None] - xbar[:, None]) ** 2) / Nk[..., None]
        alpha = alpha0 + Nk
        beta = np.broadcast_to(beta0 + Nk[..., None], xbar.shape)
        m = (beta0 * m0 + Nk[..., None] * xbar) / beta
        a = np.broadcast_to(a0 + 0.5 * Nk[..., None], xbar.shape)
        b = b0 + 0.5 * (Nk[..., None] * S + beta0 * Nk[..., None] * (xbar - m0) ** 2 / beta)
        # The free energy -ELBO of (r, the updated posterior).
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        e_log_tau, e_tau = digamma(a) - np.log(b), a / b
        quad = (e_tau[:, None] * (x[:, :, None] - m[:, None]) ** 2 + 1.0 / beta[:, None]).sum(-1)
        a_sum = alpha.sum(-1)
        elbo = (
            0.5 * (r * (e_log_tau.sum(-1)[:, None] - D * _LOG_2PI - quad)).sum((1, 2))
            + (r * e_log_pi[:, None]).sum((1, 2))
            + gammaln(K * alpha0) - K * gammaln(alpha0) + (alpha0 - 1.0) * e_log_pi.sum(-1)
            + (0.5 * (np.log(beta0) - _LOG_2PI + e_log_tau)
               - 0.5 * beta0 * (e_tau * (m - m0) ** 2 + 1.0 / beta)
               + a0 * np.log(b0) - gammaln(a0) + (a0 - 1.0) * e_log_tau - b0 * e_tau).sum((1, 2))
            - (r * log_r).sum((1, 2))
            + gammaln(alpha).sum(-1) - gammaln(a_sum)
            - ((alpha - 1.0) * (digamma(alpha) - digamma(a_sum)[:, None])).sum(-1)
            + (0.5 * (1.0 + _LOG_2PI - e_log_tau - np.log(beta))
               + a - np.log(b) + gammaln(a) + (1.0 - a) * digamma(a)).sum((1, 2))
        )
        fes.append(-elbo)
    return (alpha, m, beta, a, b), r, np.stack(fes, -1) if fes else np.zeros((n, 0))


def numpy_vb_gmm_full(x, K, init_means, n_iterations, alpha0=1.0, beta0=1.0, m0=0.0,
                      w0_scale=1.0):
    """Float64 variational Bayesian GMM with Normal–Wishart components
    (Bishop eqs. 10.46-10.63 and the free energy of 10.70-10.77), ν0 = D.
    Returns ``((alpha, m, beta, W, nu), r, free_energy)``."""
    from scipy.special import digamma, gammaln

    x = np.asarray(x, np.float64)
    n, N, D = x.shape
    nu0, W0_inv = float(D), np.eye(D) / w0_scale
    i = np.arange(1, D + 1)

    def e_logdet(nu, W):
        return (digamma((nu[..., None] + 1.0 - i) / 2.0).sum(-1) + D * math.log(2.0)
                + np.linalg.slogdet(W)[1])

    def log_B(W, nu):
        multigammaln = D * (D - 1) / 4.0 * math.log(math.pi) + gammaln(
            nu[..., None] / 2.0 + (1.0 - i) / 2.0).sum(-1)
        return -0.5 * nu * np.linalg.slogdet(W)[1] - 0.5 * nu * D * math.log(2.0) - multigammaln

    alpha, beta, nu = np.full((n, K), alpha0), np.full((n, K), beta0), np.full((n, K), nu0)
    m = np.array(init_means, np.float64)
    W = np.broadcast_to(w0_scale * np.eye(D), (n, K, D, D))
    r, fes = np.zeros((n, N, K)), []
    for _ in range(n_iterations):
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        diff = x[:, :, None] - m[:, None]
        quad = nu[:, None] * np.einsum("nikd,nkde,nike->nik", diff, W, diff) + D / beta[:, None]
        r, log_r = _numpy_responsibilities(
            e_log_pi[:, None] + 0.5 * e_logdet(nu, W)[:, None] - 0.5 * D * _LOG_2PI - 0.5 * quad)
        Nk = r.sum(1) + 1e-10
        xbar = np.einsum("nik,nid->nkd", r, x) / Nk[..., None]
        dxb = x[:, :, None] - xbar[:, None]
        S = np.einsum("nik,nikd,nike->nkde", r, dxb, dxb) / Nk[..., None, None]
        alpha, beta, nu = alpha0 + Nk, beta0 + Nk, nu0 + Nk
        m = (beta0 * m0 + Nk[..., None] * xbar) / beta[..., None]
        dm = xbar - m0
        shrink = (beta0 * Nk / beta)[..., None, None]
        W = np.linalg.inv(W0_inv + Nk[..., None, None] * S
                          + shrink * dm[..., :, None] * dm[..., None, :])
        # The free energy -ELBO of (r, the updated posterior).
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        eld = e_logdet(nu, W)
        dxm, dm0 = xbar - m, m - m0
        trace = lambda P, M: np.einsum("...kde,...ked->...k", P, M)  # noqa: E731
        quad_form = lambda v, M: np.einsum("...kd,...kde,...ke->...k", v, M, v)  # noqa: E731
        t1 = 0.5 * (Nk * (eld - D / beta - nu * trace(S, W) - nu * quad_form(dxm, W)
                          - D * _LOG_2PI)).sum(-1)
        t2 = (r * e_log_pi[:, None]).sum((1, 2))
        t3 = gammaln(K * alpha0) - K * gammaln(alpha0) + (alpha0 - 1.0) * e_log_pi.sum(-1)
        t4 = (0.5 * (D * math.log(beta0 / (2.0 * math.pi)) + eld - D * beta0 / beta
                     - beta0 * nu * quad_form(dm0, W)).sum(-1)
              + K * log_B(w0_scale * np.eye(D), np.array(nu0))
              + 0.5 * (nu0 - D - 1.0) * eld.sum(-1)
              - 0.5 * (nu * np.einsum("de,nked->nk", W0_inv, W)).sum(-1))
        t5 = (r * log_r).sum((1, 2))
        t6 = ((alpha - 1.0) * e_log_pi).sum(-1) + gammaln(alpha.sum(-1)) - gammaln(alpha).sum(-1)
        h_w = -log_B(W, nu) - 0.5 * (nu - D - 1.0) * eld + 0.5 * nu * D
        t7 = (0.5 * eld + 0.5 * D * np.log(beta / (2.0 * math.pi)) - 0.5 * D - h_w).sum(-1)
        fes.append(-(t1 + t2 + t3 + t4 - t5 - t6 - t7))
    return (alpha, m, beta, W, nu), r, np.stack(fes, -1) if fes else np.zeros((n, 0))


def numpy_bethe_chain(y, Q=1.0, A=1.0, R=1.0):
    """Float64 −log p(y_2..T | y_1) of the scalar chain over the rows of ``y``
    (n, T), by the prediction-error decomposition from the filtered belief
    of ``y_1`` alone."""
    y = np.asarray(y, np.float64)
    m, v, ll = y[:, 0].copy(), np.full(y.shape[0], R), np.zeros(y.shape[0])
    for t in range(1, y.shape[1]):
        pm, pv = A * m, A * A * v + Q
        s = pv + R
        ll -= 0.5 * (np.log(2.0 * math.pi * s) + (y[:, t] - pm) ** 2 / s)
        m, v = pm + pv / s * (y[:, t] - pm), pv - pv / s * pv
    return -ll


def _kernel_launches_zero(kernels):
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def _check_no_kernel_launched(kernels, phase: str) -> dict:
    launches = dict(kernels.LAUNCHES)
    emit(phase=phase, launches=launches, note="this path runs eager torch operations and "
         "none of K1-K4")
    if any(launches.values()):
        raise SmokeFailure(f"{phase} launched a kernel of K1-K4: {launches}")
    return launches


def run_gmm_main_path(torch, models, ops, device, R: int, N: int, D: int = GMM_D,
                      K: int = GMM_K, n_iterations: int = GMM_ITERS, n_ref: int = N_GMM,
                      chain=(R_MAIN, T_MAIN), seed: int = 0) -> list:
    """Drive the port's Gaussian-mixture slice once on ``device`` through its
    public entry points, and check every result.

    ``GMM.fit`` and ``GMMFull.fit`` on R replicas of N points (initial means
    the first K points of each replica) are held against the float64 numpy
    VB-GMMs and against the port's CPU run on the first ``n_ref`` replicas
    (GMM_TOL), their free energies against GMM_MONOTONE_RTOL on every
    replica; ``bethe_free_energy_chain`` on the LGSSM main path's data
    (``chain``: R, T) against the float64 prediction-error sum (rtol 1e-4,
    the bar of tests/test_free_energy.py).  Returns the checks."""
    from cortex_tpu_torch.ops.free_energy import bethe_free_energy_chain

    x_np = gmm_data(R, N, D, K, seed)
    x = torch.from_numpy(x_np).to(device)
    families = {"GMM": (models.GMM, numpy_vb_gmm), "GMMFull": (models.GMMFull, numpy_vb_gmm_full)}
    fits = {name: cls(K=K).fit(x, n_iterations=n_iterations, init_means=x[:, :K])
            for name, (cls, _) in families.items()}
    y_np = random_walk(*chain, seed=seed + 1)
    xi, w = ops.lgssm_messages_scan(torch.from_numpy(y_np).to(device))["obs"]
    bethe = bethe_free_energy_chain(xi, w, Q=1.0)
    if device != "cpu":
        torch.cuda.synchronize()

    checks = []
    x_cpu = torch.from_numpy(x_np[:n_ref])
    for name, (cls, reference) in families.items():
        res = fits[name]
        fe = _host64(res.free_energy)
        if res.responsibilities.shape != (R, N, K) or fe.shape != (R, n_iterations):
            raise SmokeFailure(f"{name}: shapes {tuple(res.responsibilities.shape)}, {fe.shape}")
        rise = np.diff(fe, axis=-1) - GMM_MONOTONE_RTOL * np.abs(fe[:, 1:])
        if not np.isfinite(fe).all() or (rise > 0).any():
            raise SmokeFailure(f"{name}: the free energy rose by {float(rise.max())} "
                               f"beyond {GMM_MONOTONE_RTOL} of its magnitude")
        post_ref, r_ref, fe_ref = reference(x_np[:n_ref], K, x_np[:n_ref, :K], n_iterations)
        cpu = cls(K=K).fit(x_cpu, n_iterations=n_iterations, init_means=x_cpu[:, :K])
        for against, want, tol in (
            ("float64 numpy", (*post_ref, r_ref, fe_ref), GMM_TOL["float64"]),
            ("port on cpu", (*cpu.posterior, cpu.responsibilities, cpu.free_energy),
             GMM_TOL["cpu"]),
        ):
            fields = res.posterior._fields + ("responsibilities", "free_energy")
            got = (*res.posterior, res.responsibilities, res.free_energy)
            errs = {f: check_close(f"{name} {f} vs {against}", g[:n_ref], w_, *tol)
                    for f, g, w_ in zip(fields, got, want)}
            checks.append({"path": f"{name}.fit", "against": against, "atol": tol[0],
                           "rtol": tol[1], "replicas": n_ref, "max_abs_err": errs})
        checks.append({"path": f"{name}.fit", "against": "non-increasing free energy",
                       "rtol": GMM_MONOTONE_RTOL, "replicas": R,
                       "largest_step": float(np.diff(fe, axis=-1).max()),
                       "fe_first_last_mean": [float(fe[:, 0].mean()), float(fe[:, -1].mean())]})
    checks.append({"path": "bethe_free_energy_chain", "against": "float64 prediction-error sum",
                   "rtol": 1e-4, "replicas": chain[0], "T": chain[1],
                   "max_abs_err": check_close("bethe_free_energy_chain", bethe,
                                              numpy_bethe_chain(y_np), 0.0, 1e-4)})
    return checks


def phase_gmm_main_path(torch, models, ops, kernels) -> dict:
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    checks = run_gmm_main_path(torch, models, ops, "cuda", GMM_R, GMM_N)
    launches = _check_no_kernel_launched(kernels, "gmm_main_path")
    for check in checks:
        emit(phase="gmm_main_path", R=GMM_R, N=GMM_N, D=GMM_D, K=GMM_K,
             iterations=GMM_ITERS, **check)
    seconds = time.perf_counter() - start
    emit(phase="gmm_main_path", seconds=seconds)
    return {"launches": launches, "seconds": seconds}


def phase_gmm_times(torch, models, card: str) -> dict:
    """Per VMP iteration of ``GMM`` and ``GMMFull`` at ladder.gmm's width:
    call time (CUDA events: five iterations less one, over four), device time
    and kernels (``torch.profiler``, the same difference), the host's share,
    responsibility updates per second (R·N·K/t, bench.py:710), beside the
    matched-traffic probe (read x, write an (R, N, K) array; bench.py:
    676-685) and the bound (x read once an iteration; also with the
    responsibilities written once).  Returns {path: value}."""
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    R, N, D, K = GMM_R, GMM_N, GMM_D, GMM_K
    x = torch.from_numpy(gmm_data(R, N, D, K, seed=3)).cuda()
    init = x[:, :K].contiguous()
    out = {}
    for name, cls in (("GMM", models.GMM), ("GMMFull", models.GMMFull)):
        model = cls(K=K)

        def fit(n):
            return lambda: model.fit(x, n_iterations=n, init_means=init)

        call = {n: median_ms(torch, fit(n), flush, runs=5, warmup=1) for n in (1, 5)}
        device = {n: _count_kernels(torch, fit(n)) for n in (1, 5)}
        per_iter = (call[5] - call[1]) / 4
        dev_iter = (device[5]["device_ms"] - device[1]["device_ms"]) / 4
        kernels_iter = (device[5]["kernels"] - device[1]["kernels"]) / 4
        out[name] = {"ms_per_iteration": per_iter, "device_ms_per_iteration": dev_iter}
        emit(phase="gmm_times", R=R, N=N, D=D, K=K, model=name, ms_per_iteration=per_iter,
             device_ms_per_iteration=dev_iter, host_share=1.0 - dev_iter / per_iter,
             kernels_per_iteration=kernels_iter, fit_ms=call,
             fit_device_ms={n: c["device_ms"] for n, c in device.items()},
             resp_updates_per_s=R * N * K / (per_iter / 1e3),
             top_kernels_5_iterations=device[5]["top"], card=card)

    def probe():
        return x * 1.000001, x.amax(-1, keepdim=True).expand(R, N, K).contiguous()

    probe_ms = median_ms(torch, probe, flush)
    probe_device = device_ms(torch, probe, flush)
    bound = _bound(4 * R * N * D, 0)
    bound_written = _bound(4 * R * N * (D + K), 0)
    out["probe"] = {"ms": probe_ms, "device_ms": probe_device}
    emit(phase="gmm_times", R=R, N=N, D=D, K=K, path="probe", ms=probe_ms,
         device_ms=probe_device, bound_ms_x_read=bound["bound_ms"],
         bound_ms_x_read_r_written=bound_written["bound_ms"], bound_by="bytes",
         device_over_probe={name: out[name]["device_ms_per_iteration"] / probe_device
                            for name in ("GMM", "GMMFull")} if probe_device else None,
         card=card, seconds=time.perf_counter() - start)
    return out


# -- The vector chains (phases 16, 17) -------------------------------------------------


def mv_model_arrays(d: int):
    """ladder.mv's model: A = 0.9 I, Q = H = R = P0 = I, m0 = 0."""
    eye = np.eye(d, dtype=np.float32)
    return 0.9 * eye, eye, eye, eye, np.zeros(d, np.float32), eye


def mv_data(R: int, T: int, d: int, seed: int):
    """The cumsum over time of standard normals, float32 (R, T, d)."""
    return np.random.default_rng(seed).normal(size=(R, T, d)).cumsum(axis=1).astype(np.float32)


def numpy_kalman_mv(y, A, Q, H, R, m0, P0):
    """Float64 Kalman filter and RTS smoother of every series of ``y`` (n, T,
    m), dense, under one model: the covariances do not depend on the data.
    Returns ``(filtered means (n, T, d), filtered covs (T, d, d), log
    evidence (n,), smoothed means, smoothed covs)``."""
    y = np.asarray(y, np.float64)
    A, Q, H, R, m0, P0 = (np.asarray(a, np.float64) for a in (A, Q, H, R, m0, P0))
    n, T, _ = y.shape
    d = A.shape[0]
    fm, fP, ll = np.empty((n, T, d)), np.empty((T, d, d)), np.zeros(n)
    mean, P_ = np.broadcast_to(m0, (n, d)), P0
    for t in range(T):
        if t:
            mean, P_ = mean @ A.T, A @ P_ @ A.T + Q
        S = H @ P_ @ H.T + R
        S_inv = np.linalg.inv(S)
        innov = y[:, t] - mean @ H.T
        ll -= 0.5 * (np.einsum("ni,ij,nj->n", innov, S_inv, innov)
                     + np.linalg.slogdet(2.0 * math.pi * S)[1])
        K = P_ @ H.T @ S_inv
        mean, P_ = mean + innov @ K.T, P_ - K @ S @ K.T
        fm[:, t], fP[t] = mean, P_
    sm, sP = fm.copy(), fP.copy()
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.T + Q
        G = fP[t] @ A.T @ np.linalg.inv(Pp)
        sm[:, t] = fm[:, t] + (sm[:, t + 1] - fm[:, t] @ A.T) @ G.T
        sP[t] = fP[t] + G @ (sP[t + 1] - Pp) @ G.T
    return fm, fP, ll, sm, sP


def _robust_data(R: int, T: int, seed: int):
    """A random walk with 1% of the steps shifted by ±15 (outliers) and 2%
    missing, float32 (R, T)."""
    rng = np.random.default_rng(seed)
    y = random_walk(R, T, seed)
    y += np.where(rng.random((R, T)) < 0.01, 15.0 * rng.choice([-1.0, 1.0], (R, T)), 0.0
                  ).astype(np.float32)
    y[rng.random((R, T)) < 0.02] = np.nan
    return y


def run_mv_main_path(torch, models, ops, device, shapes=MV_SHAPES, T: int = MV_T,
                     n_ref: int = N_MV, robust=(R_MAIN, T_MAIN), fit_R: int = MV_FIT_R,
                     fit_steps: int = MV_FIT_STEPS, seed: int = 0) -> list:
    """Drive the port's vector chains once on ``device`` through their public
    entry points, and check every result.

    For each (d, R) of ``shapes`` at T steps: every ``MvLGSSM.smooth``
    method, the matmul path through ``mv_lgssm_smoother_operator``, and
    ``filter`` and ``log_evidence`` against the float64 Kalman filter and
    RTS smoother on ``n_ref`` replicas (MV_TOL, MV_FILTER_TOL); per-component
    NaN gaps through scan and blocked against the port's CPU run; then
    ``robust_lgssm_smooth`` (``robust``: R, T) and ``fit_mv_lgssm_ml``
    (``fit_steps`` Adam steps on ``fit_R`` replicas at the first d) against
    the port's CPU run (MV_CPU_TOL).  Returns the checks."""
    from cortex_tpu_torch.ops.chains_mv import mv_lgssm_smooth_matmul, mv_lgssm_smoother_operator

    checks = []
    for d, R in shapes:
        arrays = mv_model_arrays(d)
        model = models.MvLGSSM.from_arrays(*arrays)
        y_np = mv_data(R, T, d, seed + d)
        y = torch.from_numpy(y_np).to(device)
        outs = {m: model.smooth(y, method=m) for m in ("scan", "blocked", "assoc", "sqrt", "auto")}
        op = mv_lgssm_smoother_operator(T, *arrays[:4], arrays[4:], device=device)
        outs["matmul"] = mv_lgssm_smooth_matmul(y, operator=op)
        filt, evidence = model.filter(y), model.log_evidence(y)
        rng = np.random.default_rng(seed + 100 + d)
        y_gaps_np = np.where(rng.random(y_np.shape) < 0.05, np.nan, y_np).astype(np.float32)
        y_gaps = torch.from_numpy(y_gaps_np).to(device)
        gapped = {m: model.smooth(y_gaps, method=m) for m in ("scan", "blocked")}
        if device != "cpu":
            torch.cuda.synchronize()

        fm, fP, ll, sm, sP = numpy_kalman_mv(y_np[:n_ref], *arrays)
        sP_all = np.broadcast_to(sP, (n_ref,) + sP.shape)
        for name, out in outs.items():
            method = model.auto_method() if name == "auto" else name
            tol = MV_TOL[method]
            if tuple(out.mean.shape) != (R, T, d) or not bool(torch.isfinite(out.mean).all()):
                raise SmokeFailure(f"d={d} {name}: mean not finite of shape ({R}, {T}, {d})")
            checks.append({
                "d": d, "R": R, "path": f"smooth {name}" + (f" ({method})" if name == "auto"
                                                             else ""),
                "against": "float64 RTS", "tol": tol, "replicas": n_ref,
                "max_abs_err_mean": check_close(f"d={d} {name} mean", out.mean[:n_ref], sm, tol),
                "max_abs_err_cov": check_close(f"d={d} {name} cov", out.cov[:n_ref], sP_all, tol),
            })
        ctol = MV_FILTER_TOL["cov"]
        checks.append({
            "d": d, "R": R, "path": "filter, log_evidence", "against": "float64 Kalman filter",
            "tol": MV_FILTER_TOL, "replicas": n_ref,
            "max_abs_err_mean": check_close(f"d={d} filter mean", filt.mean[:n_ref], fm,
                                            MV_FILTER_TOL["mean"]),
            "max_abs_err_cov": check_close(f"d={d} filter cov", filt.cov[:n_ref],
                                           np.broadcast_to(fP, (n_ref,) + fP.shape), *ctol),
            "max_abs_err_log_evidence": check_close(f"d={d} log_evidence", evidence[:n_ref], ll,
                                                    0.0, MV_FILTER_TOL["log_evidence"]),
        })
        cpu_model = models.MvLGSSM.from_arrays(*arrays)
        y_gaps_cpu = torch.from_numpy(y_gaps_np[:n_ref])
        for name, out in gapped.items():
            want = cpu_model.smooth(y_gaps_cpu, method=name)
            checks.append({
                "d": d, "R": R, "path": f"smooth {name}, per-component NaN gaps",
                "against": "port on cpu", "tol": MV_CPU_TOL, "replicas": n_ref,
                "max_abs_err_mean": check_close(f"d={d} gaps {name} mean", out.mean[:n_ref],
                                                want.mean, MV_CPU_TOL),
                "max_abs_err_cov": check_close(f"d={d} gaps {name} cov", out.cov[:n_ref],
                                               want.cov, MV_CPU_TOL),
            })

    y_np = _robust_data(*robust, seed + 7)
    kw = dict(A=0.95, Q=0.3, R=0.4, nu=4.0, prior=(0.0, 5.0))
    got = ops.robust_lgssm_smooth(torch.from_numpy(y_np).to(device), **kw)
    want = ops.robust_lgssm_smooth(torch.from_numpy(y_np[:n_ref]), **kw)
    checks.append({
        "path": "robust_lgssm_smooth", "R": robust[0], "T": robust[1], "against": "port on cpu",
        "tol": MV_CPU_TOL, "replicas": n_ref,
        "max_abs_err": {f: check_close(f"robust {f}", g[:n_ref], w_, MV_CPU_TOL)
                        for f, g, w_ in zip(got._fields, got, want)},
    })

    d = shapes[0][0]
    H = np.eye(d, dtype=np.float32)
    y_np = mv_data(fit_R, T, d, seed + 11)
    _, losses = models.fit_mv_lgssm_ml(torch.from_numpy(y_np).to(device), H=H, d=d,
                                       n_steps=fit_steps)
    _, losses_cpu = models.fit_mv_lgssm_ml(torch.from_numpy(y_np), H=H, d=d, n_steps=fit_steps)
    if not bool(losses[-1] < losses[0]):
        raise SmokeFailure(f"fit_mv_lgssm_ml: the loss did not fall: {losses.tolist()}")
    checks.append({"path": "fit_mv_lgssm_ml", "d": d, "R": fit_R, "T": T, "steps": fit_steps,
                   "against": "port on cpu", "rtol": MV_CPU_TOL, "losses": losses.tolist(),
                   "max_abs_err": check_close("fit_mv_lgssm_ml losses", losses, losses_cpu, 0.0,
                                              MV_CPU_TOL)})
    return checks


def phase_mv_main_path(torch, models, ops, kernels) -> dict:
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    checks = run_mv_main_path(torch, models, ops, "cuda")
    launches = _check_no_kernel_launched(kernels, "mv_main_path")
    for check in checks:
        emit(phase="mv_main_path", **{"T": MV_T, **check})
    seconds = time.perf_counter() - start
    emit(phase="mv_main_path", seconds=seconds)
    return {"launches": launches, "seconds": seconds}


def phase_mv_times(torch, models, card: str) -> dict:
    """Each smoothing method's call time (CUDA events), device time and
    kernels a sweep (``torch.profiler``) and the host's share at both of
    ladder.mv's shapes; ``auto_method``'s pick beside the fastest recursion
    (bench.py:791-803's ``default_vs_best_recursion``, printed, not
    asserted); ``_solve_small_logdet`` beside one batched
    ``torch.linalg.solve`` on the scan's innovation systems.  Returns {d:
    {path: ms}}."""
    from cortex_tpu_torch.ops import chains_mv

    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    result = {}
    for d, R in MV_SHAPES:
        arrays = mv_model_arrays(d)
        model = models.MvLGSSM.from_arrays(*arrays)
        y = torch.from_numpy(mv_data(R, MV_T, d, seed=20 + d)).cuda()
        op = chains_mv.mv_lgssm_smoother_operator(MV_T, *arrays[:4], arrays[4:], device="cuda")
        paths = {m: (lambda m=m: model.smooth(y, method=m)) for m in
                 ("scan", "blocked", "assoc", "sqrt")}
        paths["matmul"] = lambda: chains_mv.mv_lgssm_smooth_matmul(y, operator=op)
        # The scan's first innovation systems: S = P0 + R (m x m), with the
        # innovation and P0 Hᵀ as right-hand sides.
        S = torch.eye(d, device="cuda").expand(R, d, d) * 2.0
        rhs = torch.cat([y[:, 0, :, None], torch.eye(d, device="cuda").expand(R, d, d)], -1)
        paths["_solve_small_logdet"] = lambda: chains_mv._solve_small_logdet(S, rhs)
        paths["torch.linalg.solve"] = lambda: torch.linalg.solve(S, rhs)
        ms = {}
        for name, fn in paths.items():
            once = median_ms(torch, fn, flush, runs=1, warmup=1)
            runs = 1 if once > 300 else 3 if once > 30 else 10
            ms[name] = median_ms(torch, fn, flush, runs=runs, warmup=0)
            count = _count_kernels(torch, fn)
            ms[f"{name} device"] = count["device_ms"]
            emit(phase="mv_times", d=d, R=R, T=MV_T, path=name, ms=ms[name], runs=runs,
                 device_ms=count["device_ms"], host_share=1.0 - count["device_ms"] / ms[name],
                 kernels_per_call=count["kernels"], copies_per_call=count["copies"],
                 top_kernels=count["top"], card=card)
        best = min(("scan", "blocked", "assoc"), key=lambda m: ms[m])
        pick = model.auto_method()
        emit(phase="mv_times", d=d, R=R, T=MV_T, auto_method=pick, fastest_recursion=best,
             default_vs_best_recursion=ms[pick] / ms[best], fastest_overall=min(
                 ("scan", "blocked", "assoc", "sqrt", "matmul"), key=lambda m: ms[m]),
             solve_small_vs_library=ms["_solve_small_logdet"] / ms["torch.linalg.solve"],
             card=card)
        result[d] = ms
    emit(phase="mv_times", seconds=time.perf_counter() - start)
    return result


# -- The parallel layer (phase 18) ------------------------------------------------------

# The parallel layer at the north star's shapes (BASELINE.json: independent
# replicas and time slices of state-space models sharded across ranks,
# reductions by collectives): replica-sharded LGSSM at 10,000 x 100 with K1
# on each rank's block; time-sharded smoothing of 10,000 chains of 1,024
# steps with and without a prior; the vector chains at ladder.mv's d=4 x
# 4,096 x 100; pipelined smoothing at 10,000 x 1,024 in 4 microbatches; the
# HGF at ladder.hgf's 65,536 x 256 with K4 on each block, and streamed in 8
# chunks of 32.  The scalar model is tests/test_parallel.py's time-sharded one.
PAR_SHAPES = {
    "replica": (10_000, 100),  # R, T
    "time": (10_000, 1024, 4),  # R, T, microbatches of the pipelined path
    "mv": (4, 4096, 100),  # d, R, T
    "hgf": (65_536, 256, 32),  # R, T, chunk
}
PAR_PARAMS = {"A": 0.9, "Q": 0.3, "H": 1.0, "R": 1.5}
PAR_PRIOR = (0.5, 2.0)
# atol = rtol of each sharded path against the single-device port path on
# the same card: the JAX tests' own bars (tests/test_parallel.py: replica-
# sharded 1e-5, time-sharded 1e-3, pipelined 1e-4, vector time-sharded 2e-3;
# tests/test_hgf.py: 1e-5).  Against float64 numpy: K1's main-path bar 2e-4,
# 1e-3 for the chains of 1,024 steps, 2e-3 for the vector chains, HGF_F64_TOL.
PAR_TOL = {"replica": 1e-5, "time": 1e-3, "pipelined": 1e-4, "mv": 2e-3, "hgf": 1e-5}
PAR_F64_TOL = {"replica": 2e-4, "time": 1e-3, "pipelined": 1e-3, "mv": 2e-3,
               "hgf": HGF_F64_TOL}
# The worlds on one card: one rank over NCCL (the degenerate mesh), and four
# ranks that all compute on the card, joined by gloo (NCCL refuses two ranks
# on one device; gloo's exchanges go through host memory).
PAR_WORLDS = (("nccl", 1), ("gloo", 4))
PAR_WORLD_TIMEOUT = 300.0  # seconds a world may take, start-up included
# Timed calls of each path (3 where not named): the host-bound paths of
# thousands of launches a call take two.  Then one call under torch.profiler.
PAR_RUNS = {"replica-sharded lgssm_smooth_fused": 10, "all_converged": 10, "pipelined": 2,
            "vector time-sharded": 2, "replica-sharded HGF streaming": 2,
            "all_gather of one element alone": 10}
RANK_TIMEOUT_S = 60  # each rank's collective timeout


def run_parallel_ranks(body: str, world_size: int, workdir, *, device: str = "cpu",
                       backend: str = "gloo", timeout: float = PAR_WORLD_TIMEOUT,
                       **kwargs) -> list:
    """Run the rank body ``body`` (a function of this file) in a world of
    ``world_size`` fresh processes and return each rank's JSON result, in
    rank order.

    Each rank imports this file (torch and numpy only), joins the world by a
    rendezvous file in ``workdir`` (a directory of its own) with a collective
    timeout of RANK_TIMEOUT_S and one CPU thread, over ``backend`` on
    ``device`` (on a card: the first card, for every rank), calls
    ``body(torch, device, workdir, **kwargs)`` and writes what it returns to
    ``workdir/rank<r>.json``.  A rank that exits non-zero stops the others at
    once; a world that outlives ``timeout`` seconds is stopped.  Either
    raises SmokeFailure with the end of the rank's log."""
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    spec = json.dumps({"body": body, "world_size": world_size, "device": device,
                       "backend": backend, "init": (workdir / "rendezvous").as_uri(),
                       "workdir": str(workdir), "kwargs": kwargs})
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            "chip_smoke._rank_main(sys.argv[1], int(sys.argv[2]))")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world_size)]
    procs = []
    timed_out = False
    try:
        for r in range(world_size):
            procs.append(subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                                          stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        first = next((r for r in failed if procs[r].returncode > 0), failed[0])
        tail = (workdir / f"rank{first}.log").read_text()[-4000:]
        what = (f"outlived {timeout} s" if timed_out
                else f"rank {first} exited with {procs[first].returncode}")
        raise SmokeFailure(f"{body} in a world of {world_size} ({backend}, {device}): {what}:\n"
                           f"{tail}")
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world_size)]


def _rank_main(spec_json: str, rank: int) -> None:
    """One rank of :func:`run_parallel_ranks`: join the world, run the body,
    leave the world, and write the body's result with the seconds it took to
    join."""
    import torch
    import torch.distributed as dist

    from cortex_tpu_torch import parallel

    spec = json.loads(spec_json)
    torch.set_num_threads(1)
    start = time.perf_counter()
    parallel.init_distributed(spec["init"], spec["world_size"], rank, local_rank=0,
                              backend=spec["backend"], device=spec["device"],
                              timeout=timedelta(seconds=RANK_TIMEOUT_S))
    seconds_to_join = time.perf_counter() - start
    workdir = Path(spec["workdir"])
    try:
        result = globals()[spec["body"]](torch, spec["device"], workdir, **spec["kwargs"])
    finally:
        dist.destroy_process_group()
    result["seconds_to_join"] = seconds_to_join
    (workdir / f"rank{rank}.json").write_text(json.dumps(result))


def _profile_once(torch, fn) -> dict:
    """The device kernels (and copies) of one call of ``fn``, their device time
    and the five that take the most of it (name cut to 100 characters, ms,
    launches), from ``torch.profiler``'s raw device records (its
    ``key_averages`` builds a Python object a record, which costs far more
    on paths of tens of thousands of kernels); kernels 0 when it recorded
    none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    by_name = {}
    for event in prof.profiler.kineto_results.events():
        if event.device_type() != torch.autograd.DeviceType.CUDA or event.duration_ns() <= 0:
            continue
        name = event.name()
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + event.duration_ns() / 1e6, count + 1)
        if name.startswith(("Memcpy", "Memset")):
            copies += 1
        else:
            kernels += 1
    top = sorted(([name[:100], ms, count] for name, (ms, count) in by_name.items()),
                 key=lambda item: -item[1])[:5]
    return {"kernels": kernels, "copies": copies,
            "device_ms": sum(ms for ms, _ in by_name.values()), "top": top}


def _count_kernels(torch, fn) -> dict:
    """:func:`_profile_once` of ``fn`` after one call to warm it up, profiled
    once more when the first profile holds no kernel record."""
    fn()
    torch.cuda.synchronize()
    for _ in range(2):  # a profile now and then holds no kernel record: one more
        counted = _profile_once(torch, fn)
        if counted["kernels"]:
            break
    return counted


def phase_generic_main_path(torch, LGSSM, ops, kernels) -> dict:
    start = time.perf_counter()
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0
    checks = run_generic_main_path(torch, LGSSM, "cuda", GENERIC_R, GENERIC_T)
    launches = dict(kernels.LAUNCHES)
    for check in checks:
        emit(phase="generic_main_path", R=GENERIC_R, T=GENERIC_T, **check)
    emit(phase="generic_main_path", launches=launches,
         note="the generic path runs eager torch operations and none of K1-K4")
    # Held against K1 too, outside the counted run.
    y_np, vmp_np = generic_data(GENERIC_R, GENERIC_T)
    y, data = torch.from_numpy(y_np).cuda(), torch.from_numpy(vmp_np).cuda()
    paths = GenericPaths(torch, "cuda", GENERIC_T, GENERIC_T)
    mean, var = paths.bp(y)
    k1 = ops.lgssm_smooth_fused(y)
    emit(phase="generic_main_path", path="BP chain", against="lgssm_smooth_fused (K1)",
         tol=GENERIC_TOL["rts"],
         max_abs_err_mean=check_close("BP chain mean vs K1", mean, k1.mean, GENERIC_TOL["rts"]),
         max_abs_err_variance=check_close("BP chain variance vs K1", var, k1.variance,
                                          GENERIC_TOL["rts"]))
    counts = {
        "BP chain sweep": _count_kernels(torch, lambda: paths.bp(y)),
        f"mean-field VMP, {GENERIC_ITERS} iterations": _count_kernels(
            torch, lambda: paths.mean_field(data, GENERIC_ITERS)),
        f"structured VMP, {GENERIC_ITERS} iterations": _count_kernels(
            torch, lambda: paths.structured(data, GENERIC_ITERS)),
    }
    for path, count in counts.items():
        emit(phase="generic_main_path", path=path, per_call=count, counter="torch.profiler")
    seconds = time.perf_counter() - start
    emit(phase="generic_main_path", seconds=seconds)
    return {"launches": launches, "counts": counts, "seconds": seconds}


def phase_generic_times(torch, LGSSM, ops, card: str) -> dict:
    """CUDA-event medians of the generic paths at the main path's width,
    beside the scan and K1 (BP) and the hand-written sweep (mean-field VMP),
    with device time against call time; returns {path: ms}."""
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    y_np, vmp_np = generic_data(GENERIC_R, GENERIC_T, seed=5)
    y, data = torch.from_numpy(y_np).cuda(), torch.from_numpy(vmp_np).cuda()
    paths = GenericPaths(torch, "cuda", GENERIC_T, GENERIC_T)
    model = LGSSM()
    it, it_long = GENERIC_ITERS, GENERIC_ITERS_LONG
    timed = {
        "BP generic": (lambda: paths.bp(y), 10),
        "BP scan": (lambda: model.smooth(y, method="scan"), 10),
        "BP kernel": (lambda: ops.lgssm_smooth_fused(y), 25),
        f"mean-field VMP compiled x{it}": (lambda: paths.mean_field(data, it), 5),
        f"mean-field VMP hand-written x{it}": (lambda: handwritten_mean_field(torch, data, it), 5),
        f"structured VMP x{it}": (lambda: paths.structured(data, it), 5),
        f"structured VMP x{it_long}": (lambda: paths.structured(data, it_long), 3),
    }
    ms = {}
    # Each pair in turns A/B/A/B, as bench.py:392-397 times the VMP paths.
    for pair in (("BP generic", "BP scan", "BP kernel"),
                 (f"mean-field VMP compiled x{it}", f"mean-field VMP hand-written x{it}"),
                 (f"structured VMP x{it}", f"structured VMP x{it_long}")):
        samples = {name: [] for name in pair}
        for name in pair + pair:
            fn, runs = timed[name]
            samples[name].append(median_ms(torch, fn, flush, runs=runs, warmup=1))
        for name, rounds in samples.items():
            ms[name] = statistics.mean(rounds)
            device = _count_kernels(torch, timed[name][0])
            emit(phase="generic_times", R=GENERIC_R, T=GENERIC_T, path=name, ms=ms[name],
                 ms_rounds=rounds, device_ms=device["device_ms"],
                 host_share=1.0 - device["device_ms"] / ms[name], kernels_per_call=device["kernels"],
                 card=card)
            ms[f"{name} device"] = device["device_ms"]
    steady = (ms[f"structured VMP x{it_long}"] - ms[f"structured VMP x{it}"]) / (it_long - it)
    warm = ms[f"structured VMP x{it}"] - (it - 1) * steady
    derived = {
        "bp_ratio_vs_scan": ms["BP generic"] / ms["BP scan"],
        "bp_ratio_vs_kernel": ms["BP generic"] / ms["BP kernel"],
        "bp_message_updates_per_s": GENERIC_R * (3 * GENERIC_T - 2) / (ms["BP generic"] / 1e3),
        "vmp_us_per_iteration_compiled": ms[f"mean-field VMP compiled x{it}"] / it * 1e3,
        "vmp_us_per_iteration_handwritten": ms[f"mean-field VMP hand-written x{it}"] / it * 1e3,
        "vmp_ratio_vs_handwritten": (ms[f"mean-field VMP compiled x{it}"]
                                     / ms[f"mean-field VMP hand-written x{it}"]),
        "structured_warm_start_us": warm * 1e3,
        "structured_steady_iteration_us": steady * 1e3,
        "structured_joint_updates_per_s": GENERIC_R * (GENERIC_T - 1) / (steady / 1e3),
    }
    emit(phase="generic_times", R=GENERIC_R, T=GENERIC_T, **derived, card=card,
         seconds=time.perf_counter() - start)
    return {**ms, **derived}


# -- The Gaussian-mixture slice (phases 14, 15) -------------------------------------


_LOG_2PI = math.log(2.0 * math.pi)


def gmm_data(R: int, N: int, D: int, K: int, seed: int = 0):
    """``normal + 3·randint(0, K)`` per point, as the JAX bench's ladder.gmm
    makes its data: float32 (R, N, D), the offset shared by a point's D
    coordinates."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(R, N, D)) + 3.0 * rng.integers(0, K, size=(R, N, 1))
    return x.astype(np.float32)


def _numpy_responsibilities(log_rho):
    top = log_rho.max(-1, keepdims=True)
    log_r = log_rho - top - np.log(np.exp(log_rho - top).sum(-1, keepdims=True))
    return np.exp(log_r), log_r


def numpy_vb_gmm(x, K, init_means, n_iterations, alpha0=1.0, m0=0.0, beta0=1.0, a0=1.0,
                 b0=1.0):
    """Float64 variational Bayesian GMM with diagonal Normal–Gamma components
    (Bishop §10.2): the E-step and M-step of every iteration, then the
    closed-form free energy.  ``x`` (n, N, D).  Returns ``((alpha, m, beta,
    a, b), r, free_energy)``, the trace (n, n_iterations)."""
    from scipy.special import digamma, gammaln

    x = np.asarray(x, np.float64)
    n, N, D = x.shape
    alpha = np.full((n, K), alpha0)
    m = np.array(init_means, np.float64)
    beta, a, b = (np.full((n, K, D), v) for v in (beta0, a0, b0))
    r, fes = np.zeros((n, N, K)), []
    for _ in range(n_iterations):
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        e_log_tau, e_tau = digamma(a) - np.log(b), a / b
        quad = (e_tau[:, None] * (x[:, :, None] - m[:, None]) ** 2 + 1.0 / beta[:, None]).sum(-1)
        r, log_r = _numpy_responsibilities(
            e_log_pi[:, None] + 0.5 * e_log_tau.sum(-1)[:, None] - 0.5 * D * _LOG_2PI
            - 0.5 * quad)
        Nk = r.sum(1) + 1e-10
        xbar = np.einsum("nik,nid->nkd", r, x) / Nk[..., None]
        S = np.einsum("nik,nikd->nkd", r, (x[:, :, None] - xbar[:, None]) ** 2) / Nk[..., None]
        alpha = alpha0 + Nk
        beta = np.broadcast_to(beta0 + Nk[..., None], xbar.shape)
        m = (beta0 * m0 + Nk[..., None] * xbar) / beta
        a = np.broadcast_to(a0 + 0.5 * Nk[..., None], xbar.shape)
        b = b0 + 0.5 * (Nk[..., None] * S + beta0 * Nk[..., None] * (xbar - m0) ** 2 / beta)
        # The free energy -ELBO of (r, the updated posterior).
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        e_log_tau, e_tau = digamma(a) - np.log(b), a / b
        quad = (e_tau[:, None] * (x[:, :, None] - m[:, None]) ** 2 + 1.0 / beta[:, None]).sum(-1)
        a_sum = alpha.sum(-1)
        elbo = (
            0.5 * (r * (e_log_tau.sum(-1)[:, None] - D * _LOG_2PI - quad)).sum((1, 2))
            + (r * e_log_pi[:, None]).sum((1, 2))
            + gammaln(K * alpha0) - K * gammaln(alpha0) + (alpha0 - 1.0) * e_log_pi.sum(-1)
            + (0.5 * (np.log(beta0) - _LOG_2PI + e_log_tau)
               - 0.5 * beta0 * (e_tau * (m - m0) ** 2 + 1.0 / beta)
               + a0 * np.log(b0) - gammaln(a0) + (a0 - 1.0) * e_log_tau - b0 * e_tau).sum((1, 2))
            - (r * log_r).sum((1, 2))
            + gammaln(alpha).sum(-1) - gammaln(a_sum)
            - ((alpha - 1.0) * (digamma(alpha) - digamma(a_sum)[:, None])).sum(-1)
            + (0.5 * (1.0 + _LOG_2PI - e_log_tau - np.log(beta))
               + a - np.log(b) + gammaln(a) + (1.0 - a) * digamma(a)).sum((1, 2))
        )
        fes.append(-elbo)
    return (alpha, m, beta, a, b), r, np.stack(fes, -1) if fes else np.zeros((n, 0))


def numpy_vb_gmm_full(x, K, init_means, n_iterations, alpha0=1.0, beta0=1.0, m0=0.0,
                      w0_scale=1.0):
    """Float64 variational Bayesian GMM with Normal–Wishart components
    (Bishop eqs. 10.46-10.63 and the free energy of 10.70-10.77), ν0 = D.
    Returns ``((alpha, m, beta, W, nu), r, free_energy)``."""
    from scipy.special import digamma, gammaln

    x = np.asarray(x, np.float64)
    n, N, D = x.shape
    nu0, W0_inv = float(D), np.eye(D) / w0_scale
    i = np.arange(1, D + 1)

    def e_logdet(nu, W):
        return (digamma((nu[..., None] + 1.0 - i) / 2.0).sum(-1) + D * math.log(2.0)
                + np.linalg.slogdet(W)[1])

    def log_B(W, nu):
        multigammaln = D * (D - 1) / 4.0 * math.log(math.pi) + gammaln(
            nu[..., None] / 2.0 + (1.0 - i) / 2.0).sum(-1)
        return -0.5 * nu * np.linalg.slogdet(W)[1] - 0.5 * nu * D * math.log(2.0) - multigammaln

    alpha, beta, nu = np.full((n, K), alpha0), np.full((n, K), beta0), np.full((n, K), nu0)
    m = np.array(init_means, np.float64)
    W = np.broadcast_to(w0_scale * np.eye(D), (n, K, D, D))
    r, fes = np.zeros((n, N, K)), []
    for _ in range(n_iterations):
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        diff = x[:, :, None] - m[:, None]
        quad = nu[:, None] * np.einsum("nikd,nkde,nike->nik", diff, W, diff) + D / beta[:, None]
        r, log_r = _numpy_responsibilities(
            e_log_pi[:, None] + 0.5 * e_logdet(nu, W)[:, None] - 0.5 * D * _LOG_2PI - 0.5 * quad)
        Nk = r.sum(1) + 1e-10
        xbar = np.einsum("nik,nid->nkd", r, x) / Nk[..., None]
        dxb = x[:, :, None] - xbar[:, None]
        S = np.einsum("nik,nikd,nike->nkde", r, dxb, dxb) / Nk[..., None, None]
        alpha, beta, nu = alpha0 + Nk, beta0 + Nk, nu0 + Nk
        m = (beta0 * m0 + Nk[..., None] * xbar) / beta[..., None]
        dm = xbar - m0
        shrink = (beta0 * Nk / beta)[..., None, None]
        W = np.linalg.inv(W0_inv + Nk[..., None, None] * S
                          + shrink * dm[..., :, None] * dm[..., None, :])
        # The free energy -ELBO of (r, the updated posterior).
        e_log_pi = digamma(alpha) - digamma(alpha.sum(-1, keepdims=True))
        eld = e_logdet(nu, W)
        dxm, dm0 = xbar - m, m - m0
        trace = lambda P, M: np.einsum("...kde,...ked->...k", P, M)  # noqa: E731
        quad_form = lambda v, M: np.einsum("...kd,...kde,...ke->...k", v, M, v)  # noqa: E731
        t1 = 0.5 * (Nk * (eld - D / beta - nu * trace(S, W) - nu * quad_form(dxm, W)
                          - D * _LOG_2PI)).sum(-1)
        t2 = (r * e_log_pi[:, None]).sum((1, 2))
        t3 = gammaln(K * alpha0) - K * gammaln(alpha0) + (alpha0 - 1.0) * e_log_pi.sum(-1)
        t4 = (0.5 * (D * math.log(beta0 / (2.0 * math.pi)) + eld - D * beta0 / beta
                     - beta0 * nu * quad_form(dm0, W)).sum(-1)
              + K * log_B(w0_scale * np.eye(D), np.array(nu0))
              + 0.5 * (nu0 - D - 1.0) * eld.sum(-1)
              - 0.5 * (nu * np.einsum("de,nked->nk", W0_inv, W)).sum(-1))
        t5 = (r * log_r).sum((1, 2))
        t6 = ((alpha - 1.0) * e_log_pi).sum(-1) + gammaln(alpha.sum(-1)) - gammaln(alpha).sum(-1)
        h_w = -log_B(W, nu) - 0.5 * (nu - D - 1.0) * eld + 0.5 * nu * D
        t7 = (0.5 * eld + 0.5 * D * np.log(beta / (2.0 * math.pi)) - 0.5 * D - h_w).sum(-1)
        fes.append(-(t1 + t2 + t3 + t4 - t5 - t6 - t7))
    return (alpha, m, beta, W, nu), r, np.stack(fes, -1) if fes else np.zeros((n, 0))


def numpy_bethe_chain(y, Q=1.0, A=1.0, R=1.0):
    """Float64 −log p(y_2..T | y_1) of the scalar chain over the rows of ``y``
    (n, T), by the prediction-error decomposition from the filtered belief
    of ``y_1`` alone."""
    y = np.asarray(y, np.float64)
    m, v, ll = y[:, 0].copy(), np.full(y.shape[0], R), np.zeros(y.shape[0])
    for t in range(1, y.shape[1]):
        pm, pv = A * m, A * A * v + Q
        s = pv + R
        ll -= 0.5 * (np.log(2.0 * math.pi * s) + (y[:, t] - pm) ** 2 / s)
        m, v = pm + pv / s * (y[:, t] - pm), pv - pv / s * pv
    return -ll


def _kernel_launches_zero(kernels):
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0


def _check_no_kernel_launched(kernels, phase: str) -> dict:
    launches = dict(kernels.LAUNCHES)
    emit(phase=phase, launches=launches, note="this path runs eager torch operations and "
         "none of K1-K4")
    if any(launches.values()):
        raise SmokeFailure(f"{phase} launched a kernel of K1-K4: {launches}")
    return launches


def run_gmm_main_path(torch, models, ops, device, R: int, N: int, D: int = GMM_D,
                      K: int = GMM_K, n_iterations: int = GMM_ITERS, n_ref: int = N_GMM,
                      chain=(R_MAIN, T_MAIN), seed: int = 0) -> list:
    """Drive the port's Gaussian-mixture slice once on ``device`` through its
    public entry points, and check every result.

    ``GMM.fit`` and ``GMMFull.fit`` on R replicas of N points (initial means
    the first K points of each replica) are held against the float64 numpy
    VB-GMMs and against the port's CPU run on the first ``n_ref`` replicas
    (GMM_TOL), their free energies against GMM_MONOTONE_RTOL on every
    replica; ``bethe_free_energy_chain`` on the LGSSM main path's data
    (``chain``: R, T) against the float64 prediction-error sum (rtol 1e-4,
    the bar of tests/test_free_energy.py).  Returns the checks."""
    from cortex_tpu_torch.ops.free_energy import bethe_free_energy_chain

    x_np = gmm_data(R, N, D, K, seed)
    x = torch.from_numpy(x_np).to(device)
    families = {"GMM": (models.GMM, numpy_vb_gmm), "GMMFull": (models.GMMFull, numpy_vb_gmm_full)}
    fits = {name: cls(K=K).fit(x, n_iterations=n_iterations, init_means=x[:, :K])
            for name, (cls, _) in families.items()}
    y_np = random_walk(*chain, seed=seed + 1)
    xi, w = ops.lgssm_messages_scan(torch.from_numpy(y_np).to(device))["obs"]
    bethe = bethe_free_energy_chain(xi, w, Q=1.0)
    if device != "cpu":
        torch.cuda.synchronize()

    checks = []
    x_cpu = torch.from_numpy(x_np[:n_ref])
    for name, (cls, reference) in families.items():
        res = fits[name]
        fe = _host64(res.free_energy)
        if res.responsibilities.shape != (R, N, K) or fe.shape != (R, n_iterations):
            raise SmokeFailure(f"{name}: shapes {tuple(res.responsibilities.shape)}, {fe.shape}")
        rise = np.diff(fe, axis=-1) - GMM_MONOTONE_RTOL * np.abs(fe[:, 1:])
        if not np.isfinite(fe).all() or (rise > 0).any():
            raise SmokeFailure(f"{name}: the free energy rose by {float(rise.max())} "
                               f"beyond {GMM_MONOTONE_RTOL} of its magnitude")
        post_ref, r_ref, fe_ref = reference(x_np[:n_ref], K, x_np[:n_ref, :K], n_iterations)
        cpu = cls(K=K).fit(x_cpu, n_iterations=n_iterations, init_means=x_cpu[:, :K])
        for against, want, tol in (
            ("float64 numpy", (*post_ref, r_ref, fe_ref), GMM_TOL["float64"]),
            ("port on cpu", (*cpu.posterior, cpu.responsibilities, cpu.free_energy),
             GMM_TOL["cpu"]),
        ):
            fields = res.posterior._fields + ("responsibilities", "free_energy")
            got = (*res.posterior, res.responsibilities, res.free_energy)
            errs = {f: check_close(f"{name} {f} vs {against}", g[:n_ref], w_, *tol)
                    for f, g, w_ in zip(fields, got, want)}
            checks.append({"path": f"{name}.fit", "against": against, "atol": tol[0],
                           "rtol": tol[1], "replicas": n_ref, "max_abs_err": errs})
        checks.append({"path": f"{name}.fit", "against": "non-increasing free energy",
                       "rtol": GMM_MONOTONE_RTOL, "replicas": R,
                       "largest_step": float(np.diff(fe, axis=-1).max()),
                       "fe_first_last_mean": [float(fe[:, 0].mean()), float(fe[:, -1].mean())]})
    checks.append({"path": "bethe_free_energy_chain", "against": "float64 prediction-error sum",
                   "rtol": 1e-4, "replicas": chain[0], "T": chain[1],
                   "max_abs_err": check_close("bethe_free_energy_chain", bethe,
                                              numpy_bethe_chain(y_np), 0.0, 1e-4)})
    return checks


def phase_gmm_main_path(torch, models, ops, kernels) -> dict:
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    checks = run_gmm_main_path(torch, models, ops, "cuda", GMM_R, GMM_N)
    launches = _check_no_kernel_launched(kernels, "gmm_main_path")
    for check in checks:
        emit(phase="gmm_main_path", R=GMM_R, N=GMM_N, D=GMM_D, K=GMM_K,
             iterations=GMM_ITERS, **check)
    seconds = time.perf_counter() - start
    emit(phase="gmm_main_path", seconds=seconds)
    return {"launches": launches, "seconds": seconds}


def phase_gmm_times(torch, models, card: str) -> dict:
    """Per VMP iteration of ``GMM`` and ``GMMFull`` at ladder.gmm's width:
    call time (CUDA events: five iterations less one, over four), device time
    and kernels (``torch.profiler``, the same difference), the host's share,
    responsibility updates per second (R·N·K/t, bench.py:710), beside the
    matched-traffic probe (read x, write an (R, N, K) array; bench.py:
    676-685) and the bound (x read once an iteration; also with the
    responsibilities written once).  Returns {path: value}."""
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    R, N, D, K = GMM_R, GMM_N, GMM_D, GMM_K
    x = torch.from_numpy(gmm_data(R, N, D, K, seed=3)).cuda()
    init = x[:, :K].contiguous()
    out = {}
    for name, cls in (("GMM", models.GMM), ("GMMFull", models.GMMFull)):
        model = cls(K=K)

        def fit(n):
            return lambda: model.fit(x, n_iterations=n, init_means=init)

        call = {n: median_ms(torch, fit(n), flush, runs=5, warmup=1) for n in (1, 5)}
        device = {n: _count_kernels(torch, fit(n)) for n in (1, 5)}
        per_iter = (call[5] - call[1]) / 4
        dev_iter = (device[5]["device_ms"] - device[1]["device_ms"]) / 4
        kernels_iter = (device[5]["kernels"] - device[1]["kernels"]) / 4
        out[name] = {"ms_per_iteration": per_iter, "device_ms_per_iteration": dev_iter}
        emit(phase="gmm_times", R=R, N=N, D=D, K=K, model=name, ms_per_iteration=per_iter,
             device_ms_per_iteration=dev_iter, host_share=1.0 - dev_iter / per_iter,
             kernels_per_iteration=kernels_iter, fit_ms=call,
             fit_device_ms={n: c["device_ms"] for n, c in device.items()},
             resp_updates_per_s=R * N * K / (per_iter / 1e3),
             top_kernels_5_iterations=device[5]["top"], card=card)

    def probe():
        return x * 1.000001, x.amax(-1, keepdim=True).expand(R, N, K).contiguous()

    probe_ms = median_ms(torch, probe, flush)
    probe_device = device_ms(torch, probe, flush)
    bound = _bound(4 * R * N * D, 0)
    bound_written = _bound(4 * R * N * (D + K), 0)
    out["probe"] = {"ms": probe_ms, "device_ms": probe_device}
    emit(phase="gmm_times", R=R, N=N, D=D, K=K, path="probe", ms=probe_ms,
         device_ms=probe_device, bound_ms_x_read=bound["bound_ms"],
         bound_ms_x_read_r_written=bound_written["bound_ms"], bound_by="bytes",
         device_over_probe={name: out[name]["device_ms_per_iteration"] / probe_device
                            for name in ("GMM", "GMMFull")} if probe_device else None,
         card=card, seconds=time.perf_counter() - start)
    return out


# -- The vector chains (phases 16, 17) -------------------------------------------------


def mv_model_arrays(d: int):
    """ladder.mv's model: A = 0.9 I, Q = H = R = P0 = I, m0 = 0."""
    eye = np.eye(d, dtype=np.float32)
    return 0.9 * eye, eye, eye, eye, np.zeros(d, np.float32), eye


def mv_data(R: int, T: int, d: int, seed: int):
    """The cumsum over time of standard normals, float32 (R, T, d)."""
    return np.random.default_rng(seed).normal(size=(R, T, d)).cumsum(axis=1).astype(np.float32)


def numpy_kalman_mv(y, A, Q, H, R, m0, P0):
    """Float64 Kalman filter and RTS smoother of every series of ``y`` (n, T,
    m), dense, under one model: the covariances do not depend on the data.
    Returns ``(filtered means (n, T, d), filtered covs (T, d, d), log
    evidence (n,), smoothed means, smoothed covs)``."""
    y = np.asarray(y, np.float64)
    A, Q, H, R, m0, P0 = (np.asarray(a, np.float64) for a in (A, Q, H, R, m0, P0))
    n, T, _ = y.shape
    d = A.shape[0]
    fm, fP, ll = np.empty((n, T, d)), np.empty((T, d, d)), np.zeros(n)
    mean, P_ = np.broadcast_to(m0, (n, d)), P0
    for t in range(T):
        if t:
            mean, P_ = mean @ A.T, A @ P_ @ A.T + Q
        S = H @ P_ @ H.T + R
        S_inv = np.linalg.inv(S)
        innov = y[:, t] - mean @ H.T
        ll -= 0.5 * (np.einsum("ni,ij,nj->n", innov, S_inv, innov)
                     + np.linalg.slogdet(2.0 * math.pi * S)[1])
        K = P_ @ H.T @ S_inv
        mean, P_ = mean + innov @ K.T, P_ - K @ S @ K.T
        fm[:, t], fP[t] = mean, P_
    sm, sP = fm.copy(), fP.copy()
    for t in range(T - 2, -1, -1):
        Pp = A @ fP[t] @ A.T + Q
        G = fP[t] @ A.T @ np.linalg.inv(Pp)
        sm[:, t] = fm[:, t] + (sm[:, t + 1] - fm[:, t] @ A.T) @ G.T
        sP[t] = fP[t] + G @ (sP[t + 1] - Pp) @ G.T
    return fm, fP, ll, sm, sP


def _robust_data(R: int, T: int, seed: int):
    """A random walk with 1% of the steps shifted by ±15 (outliers) and 2%
    missing, float32 (R, T)."""
    rng = np.random.default_rng(seed)
    y = random_walk(R, T, seed)
    y += np.where(rng.random((R, T)) < 0.01, 15.0 * rng.choice([-1.0, 1.0], (R, T)), 0.0
                  ).astype(np.float32)
    y[rng.random((R, T)) < 0.02] = np.nan
    return y


def run_mv_main_path(torch, models, ops, device, shapes=MV_SHAPES, T: int = MV_T,
                     n_ref: int = N_MV, robust=(R_MAIN, T_MAIN), fit_R: int = MV_FIT_R,
                     fit_steps: int = MV_FIT_STEPS, seed: int = 0) -> list:
    """Drive the port's vector chains once on ``device`` through their public
    entry points, and check every result.

    For each (d, R) of ``shapes`` at T steps: every ``MvLGSSM.smooth``
    method, the matmul path through ``mv_lgssm_smoother_operator``, and
    ``filter`` and ``log_evidence`` against the float64 Kalman filter and
    RTS smoother on ``n_ref`` replicas (MV_TOL, MV_FILTER_TOL); per-component
    NaN gaps through scan and blocked against the port's CPU run; then
    ``robust_lgssm_smooth`` (``robust``: R, T) and ``fit_mv_lgssm_ml``
    (``fit_steps`` Adam steps on ``fit_R`` replicas at the first d) against
    the port's CPU run (MV_CPU_TOL).  Returns the checks."""
    from cortex_tpu_torch.ops.chains_mv import mv_lgssm_smooth_matmul, mv_lgssm_smoother_operator

    checks = []
    for d, R in shapes:
        arrays = mv_model_arrays(d)
        model = models.MvLGSSM.from_arrays(*arrays)
        y_np = mv_data(R, T, d, seed + d)
        y = torch.from_numpy(y_np).to(device)
        outs = {m: model.smooth(y, method=m) for m in ("scan", "blocked", "assoc", "sqrt", "auto")}
        op = mv_lgssm_smoother_operator(T, *arrays[:4], arrays[4:], device=device)
        outs["matmul"] = mv_lgssm_smooth_matmul(y, operator=op)
        filt, evidence = model.filter(y), model.log_evidence(y)
        rng = np.random.default_rng(seed + 100 + d)
        y_gaps_np = np.where(rng.random(y_np.shape) < 0.05, np.nan, y_np).astype(np.float32)
        y_gaps = torch.from_numpy(y_gaps_np).to(device)
        gapped = {m: model.smooth(y_gaps, method=m) for m in ("scan", "blocked")}
        if device != "cpu":
            torch.cuda.synchronize()

        fm, fP, ll, sm, sP = numpy_kalman_mv(y_np[:n_ref], *arrays)
        sP_all = np.broadcast_to(sP, (n_ref,) + sP.shape)
        for name, out in outs.items():
            method = model.auto_method() if name == "auto" else name
            tol = MV_TOL[method]
            if tuple(out.mean.shape) != (R, T, d) or not bool(torch.isfinite(out.mean).all()):
                raise SmokeFailure(f"d={d} {name}: mean not finite of shape ({R}, {T}, {d})")
            checks.append({
                "d": d, "R": R, "path": f"smooth {name}" + (f" ({method})" if name == "auto"
                                                             else ""),
                "against": "float64 RTS", "tol": tol, "replicas": n_ref,
                "max_abs_err_mean": check_close(f"d={d} {name} mean", out.mean[:n_ref], sm, tol),
                "max_abs_err_cov": check_close(f"d={d} {name} cov", out.cov[:n_ref], sP_all, tol),
            })
        ctol = MV_FILTER_TOL["cov"]
        checks.append({
            "d": d, "R": R, "path": "filter, log_evidence", "against": "float64 Kalman filter",
            "tol": MV_FILTER_TOL, "replicas": n_ref,
            "max_abs_err_mean": check_close(f"d={d} filter mean", filt.mean[:n_ref], fm,
                                            MV_FILTER_TOL["mean"]),
            "max_abs_err_cov": check_close(f"d={d} filter cov", filt.cov[:n_ref],
                                           np.broadcast_to(fP, (n_ref,) + fP.shape), *ctol),
            "max_abs_err_log_evidence": check_close(f"d={d} log_evidence", evidence[:n_ref], ll,
                                                    0.0, MV_FILTER_TOL["log_evidence"]),
        })
        cpu_model = models.MvLGSSM.from_arrays(*arrays)
        y_gaps_cpu = torch.from_numpy(y_gaps_np[:n_ref])
        for name, out in gapped.items():
            want = cpu_model.smooth(y_gaps_cpu, method=name)
            checks.append({
                "d": d, "R": R, "path": f"smooth {name}, per-component NaN gaps",
                "against": "port on cpu", "tol": MV_CPU_TOL, "replicas": n_ref,
                "max_abs_err_mean": check_close(f"d={d} gaps {name} mean", out.mean[:n_ref],
                                                want.mean, MV_CPU_TOL),
                "max_abs_err_cov": check_close(f"d={d} gaps {name} cov", out.cov[:n_ref],
                                               want.cov, MV_CPU_TOL),
            })

    y_np = _robust_data(*robust, seed + 7)
    kw = dict(A=0.95, Q=0.3, R=0.4, nu=4.0, prior=(0.0, 5.0))
    got = ops.robust_lgssm_smooth(torch.from_numpy(y_np).to(device), **kw)
    want = ops.robust_lgssm_smooth(torch.from_numpy(y_np[:n_ref]), **kw)
    checks.append({
        "path": "robust_lgssm_smooth", "R": robust[0], "T": robust[1], "against": "port on cpu",
        "tol": MV_CPU_TOL, "replicas": n_ref,
        "max_abs_err": {f: check_close(f"robust {f}", g[:n_ref], w_, MV_CPU_TOL)
                        for f, g, w_ in zip(got._fields, got, want)},
    })

    d = shapes[0][0]
    H = np.eye(d, dtype=np.float32)
    y_np = mv_data(fit_R, T, d, seed + 11)
    _, losses = models.fit_mv_lgssm_ml(torch.from_numpy(y_np).to(device), H=H, d=d,
                                       n_steps=fit_steps)
    _, losses_cpu = models.fit_mv_lgssm_ml(torch.from_numpy(y_np), H=H, d=d, n_steps=fit_steps)
    if not bool(losses[-1] < losses[0]):
        raise SmokeFailure(f"fit_mv_lgssm_ml: the loss did not fall: {losses.tolist()}")
    checks.append({"path": "fit_mv_lgssm_ml", "d": d, "R": fit_R, "T": T, "steps": fit_steps,
                   "against": "port on cpu", "rtol": MV_CPU_TOL, "losses": losses.tolist(),
                   "max_abs_err": check_close("fit_mv_lgssm_ml losses", losses, losses_cpu, 0.0,
                                              MV_CPU_TOL)})
    return checks


def phase_mv_main_path(torch, models, ops, kernels) -> dict:
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    checks = run_mv_main_path(torch, models, ops, "cuda")
    launches = _check_no_kernel_launched(kernels, "mv_main_path")
    for check in checks:
        emit(phase="mv_main_path", **{"T": MV_T, **check})
    seconds = time.perf_counter() - start
    emit(phase="mv_main_path", seconds=seconds)
    return {"launches": launches, "seconds": seconds}


def phase_mv_times(torch, models, card: str) -> dict:
    """Each smoothing method's call time (CUDA events), device time and
    kernels a sweep (``torch.profiler``) and the host's share at both of
    ladder.mv's shapes; ``auto_method``'s pick beside the fastest recursion
    (bench.py:791-803's ``default_vs_best_recursion``, printed, not
    asserted); ``_solve_small_logdet`` beside one batched
    ``torch.linalg.solve`` on the scan's innovation systems.  Returns {d:
    {path: ms}}."""
    from cortex_tpu_torch.ops import chains_mv

    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    result = {}
    for d, R in MV_SHAPES:
        arrays = mv_model_arrays(d)
        model = models.MvLGSSM.from_arrays(*arrays)
        y = torch.from_numpy(mv_data(R, MV_T, d, seed=20 + d)).cuda()
        op = chains_mv.mv_lgssm_smoother_operator(MV_T, *arrays[:4], arrays[4:], device="cuda")
        paths = {m: (lambda m=m: model.smooth(y, method=m)) for m in
                 ("scan", "blocked", "assoc", "sqrt")}
        paths["matmul"] = lambda: chains_mv.mv_lgssm_smooth_matmul(y, operator=op)
        # The scan's first innovation systems: S = P0 + R (m x m), with the
        # innovation and P0 Hᵀ as right-hand sides.
        S = torch.eye(d, device="cuda").expand(R, d, d) * 2.0
        rhs = torch.cat([y[:, 0, :, None], torch.eye(d, device="cuda").expand(R, d, d)], -1)
        paths["_solve_small_logdet"] = lambda: chains_mv._solve_small_logdet(S, rhs)
        paths["torch.linalg.solve"] = lambda: torch.linalg.solve(S, rhs)
        ms = {}
        for name, fn in paths.items():
            once = median_ms(torch, fn, flush, runs=1, warmup=1)
            runs = 1 if once > 300 else 3 if once > 30 else 10
            ms[name] = median_ms(torch, fn, flush, runs=runs, warmup=0)
            count = _count_kernels(torch, fn)
            ms[f"{name} device"] = count["device_ms"]
            emit(phase="mv_times", d=d, R=R, T=MV_T, path=name, ms=ms[name], runs=runs,
                 device_ms=count["device_ms"], host_share=1.0 - count["device_ms"] / ms[name],
                 kernels_per_call=count["kernels"], copies_per_call=count["copies"],
                 top_kernels=count["top"], card=card)
        best = min(("scan", "blocked", "assoc"), key=lambda m: ms[m])
        pick = model.auto_method()
        emit(phase="mv_times", d=d, R=R, T=MV_T, auto_method=pick, fastest_recursion=best,
             default_vs_best_recursion=ms[pick] / ms[best], fastest_overall=min(
                 ("scan", "blocked", "assoc", "sqrt", "matmul"), key=lambda m: ms[m]),
             solve_small_vs_library=ms["_solve_small_logdet"] / ms["torch.linalg.solve"],
             card=card)
        result[d] = ms
    emit(phase="mv_times", seconds=time.perf_counter() - start)
    return result


# -- The parallel layer (phase 18) ------------------------------------------------------

# The parallel layer at the north star's shapes (BASELINE.json: independent
# replicas and time slices of state-space models sharded across ranks,
# reductions by collectives): replica-sharded LGSSM at 10,000 x 100 with K1
# on each rank's block; time-sharded smoothing of 10,000 chains of 1,024
# steps with and without a prior; the vector chains at ladder.mv's d=4 x
# 4,096 x 100; pipelined smoothing at 10,000 x 1,024 in 4 microbatches; the
# HGF at ladder.hgf's 65,536 x 256 with K4 on each block, and streamed in 8
# chunks of 32.  The scalar model is tests/test_parallel.py's time-sharded one.
PAR_SHAPES = {
    "replica": (10_000, 100),  # R, T
    "time": (10_000, 1024, 4),  # R, T, microbatches of the pipelined path
    "mv": (4, 4096, 100),  # d, R, T
    "hgf": (65_536, 256, 32),  # R, T, chunk
}
PAR_PARAMS = {"A": 0.9, "Q": 0.3, "H": 1.0, "R": 1.5}
PAR_PRIOR = (0.5, 2.0)
# atol = rtol of each sharded path against the single-device port path on
# the same card: the JAX tests' own bars (tests/test_parallel.py: replica-
# sharded 1e-5, time-sharded 1e-3, pipelined 1e-4, vector time-sharded 2e-3;
# tests/test_hgf.py: 1e-5).  Against float64 numpy: K1's main-path bar 2e-4,
# 1e-3 for the chains of 1,024 steps, 2e-3 for the vector chains, HGF_F64_TOL.
PAR_TOL = {"replica": 1e-5, "time": 1e-3, "pipelined": 1e-4, "mv": 2e-3, "hgf": 1e-5}
PAR_F64_TOL = {"replica": 2e-4, "time": 1e-3, "pipelined": 1e-3, "mv": 2e-3,
               "hgf": HGF_F64_TOL}
# The worlds on one card: one rank over NCCL (the degenerate mesh), and four
# ranks that all compute on the card, joined by gloo (NCCL refuses two ranks
# on one device; gloo's exchanges go through host memory).
PAR_WORLDS = (("nccl", 1), ("gloo", 4))
PAR_WORLD_TIMEOUT = 300.0  # seconds a world may take, start-up included
# Timed calls of each path (3 where not named): the host-bound paths of
# thousands of launches a call take two.  Then one call under torch.profiler.
PAR_RUNS = {"replica-sharded lgssm_smooth_fused": 10, "all_converged": 10, "pipelined": 2,
            "vector time-sharded": 2, "replica-sharded HGF streaming": 2,
            "all_gather of one element alone": 10}
RANK_TIMEOUT_S = 60  # each rank's collective timeout


def run_parallel_ranks(body: str, world_size: int, workdir, *, device: str = "cpu",
                       backend: str = "gloo", timeout: float = PAR_WORLD_TIMEOUT,
                       **kwargs) -> list:
    """Run the rank body ``body`` (a function of this file) in a world of
    ``world_size`` fresh processes and return each rank's JSON result, in
    rank order.

    Each rank imports this file (torch and numpy only), joins the world by a
    rendezvous file in ``workdir`` (a directory of its own) with a collective
    timeout of RANK_TIMEOUT_S and one CPU thread, over ``backend`` on
    ``device`` (on a card: the first card, for every rank), calls
    ``body(torch, device, workdir, **kwargs)`` and writes what it returns to
    ``workdir/rank<r>.json``.  A rank that exits non-zero stops the others at
    once; a world that outlives ``timeout`` seconds is stopped.  Either
    raises SmokeFailure with the end of the rank's log."""
    workdir = Path(workdir).resolve()
    workdir.mkdir(parents=True, exist_ok=True)
    spec = json.dumps({"body": body, "world_size": world_size, "device": device,
                       "backend": backend, "init": (workdir / "rendezvous").as_uri(),
                       "workdir": str(workdir), "kwargs": kwargs})
    code = (f"import sys; sys.path.insert(0, {REPO!r}); import chip_smoke; "
            "chip_smoke._rank_main(sys.argv[1], int(sys.argv[2]))")
    logs = [open(workdir / f"rank{r}.log", "w") for r in range(world_size)]
    procs = []
    timed_out = False
    try:
        for r in range(world_size):
            procs.append(subprocess.Popen([sys.executable, "-c", code, spec, str(r)],
                                          stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for log in logs:
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        first = next((r for r in failed if procs[r].returncode > 0), failed[0])
        tail = (workdir / f"rank{first}.log").read_text()[-4000:]
        what = (f"outlived {timeout} s" if timed_out
                else f"rank {first} exited with {procs[first].returncode}")
        raise SmokeFailure(f"{body} in a world of {world_size} ({backend}, {device}): {what}:\n"
                           f"{tail}")
    return [json.loads((workdir / f"rank{r}.json").read_text()) for r in range(world_size)]


def _rank_main(spec_json: str, rank: int) -> None:
    """One rank of :func:`run_parallel_ranks`, in a process of its own."""
    import torch

    spec = json.loads(spec_json)
    torch.set_num_threads(1)
    result = run_rank(torch, spec, rank)
    (Path(spec["workdir"]) / f"rank{rank}.json").write_text(json.dumps(result))


def run_rank(torch, spec: dict, rank: int) -> dict:
    """Join the world of ``spec`` (as run_parallel_ranks makes it) as
    ``rank``, run its body, leave the world, and return the body's result
    with the seconds it took to join."""
    import torch.distributed as dist

    from cortex_tpu_torch import parallel

    start = time.perf_counter()
    parallel.init_distributed(spec["init"], spec["world_size"], rank, local_rank=0,
                              backend=spec["backend"], device=spec["device"],
                              timeout=timedelta(seconds=RANK_TIMEOUT_S))
    seconds_to_join = time.perf_counter() - start
    try:
        result = globals()[spec["body"]](torch, spec["device"], Path(spec["workdir"]),
                                         **spec["kwargs"])
    finally:
        dist.destroy_process_group()
    result["seconds_to_join"] = seconds_to_join
    return result


def _rank_times(torch, fn, mesh, flush, runs: int) -> dict:
    """One sharded path's call time (CUDA events, median of ``runs``; the main
    path's run was the warm-up), its collectives and the bytes this rank sent
    in them per call, the host's time in them (median of the same calls) and
    its share of the call, and one profiled call's device time and kernels.  Every
    rank calls ``fn`` the same number of times, so that their collectives
    meet; only a path that makes no collective is profiled once more when its
    profile holds no kernel record."""
    torch.distributed.barrier()  # start each path together, whatever came before
    calls, nbytes = mesh.stats.calls, mesh.stats.bytes
    in_collectives = []

    def call():
        before = mesh.stats.seconds
        fn()
        in_collectives.append(mesh.stats.seconds - before)

    ms = median_ms(torch, call, flush, runs=runs, warmup=0)
    collectives = (mesh.stats.calls - calls) / runs
    collective_bytes = (mesh.stats.bytes - nbytes) / runs
    collective_ms = statistics.median(in_collectives) * 1e3
    prof = _profile_once(torch, fn)
    if not prof["kernels"] and not collectives:
        prof = _profile_once(torch, fn)
    return {"ms": ms, "collectives_per_call": collectives,
            "bytes_sent_per_call": collective_bytes, "collective_ms": collective_ms,
            "collective_share": collective_ms / ms,
            "device_ms": prof["device_ms"] if prof["kernels"] else None,
            "host_share": 1.0 - prof["device_ms"] / ms if prof["kernels"] else None,
            "kernels_per_call": prof["kernels"], "copies_per_call": prof["copies"],
            "top_kernels": prof["top"]}


def parallel_main_path_rank(torch, device: str, workdir, shapes=None, n_ref: int = N_RTS,
                            timed: bool = True) -> dict:
    """The body of one rank of the parallel main path (run_parallel_ranks).

    Makes a replica mesh and a time mesh over the world, takes this rank's
    block of each input (made whole from its seed on every rank), then:
    computes the single-device port results on the whole inputs; sets the
    kernel counts to 0; drives the sharded paths of PAR_SHAPES (``shapes``
    overrides them) through their entry points; reads the counts; holds each
    block against the single-device result's block (PAR_TOL) and against
    float64 numpy on ``n_ref`` replicas (PAR_F64_TOL); and, when ``timed``
    (on a card), times each path.  Returns the rank's checks, launches,
    times and the seconds of each stage."""
    from cortex_tpu_torch import models, ops, parallel
    from cortex_tpu_torch.ops import kernels

    clock = [time.perf_counter()]
    seconds = {}

    def stage(name):
        clock.append(time.perf_counter())
        seconds[name] = clock[-1] - clock[-2]

    shapes = {**PAR_SHAPES, **(shapes or {})}
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    rmesh = parallel.make_mesh([("replica", -1)], device=device)
    tmesh = parallel.make_mesh([("time", -1)], device=device)
    dev = rmesh.device
    by_time = parallel.NamedSharding(tmesh, parallel.P(None, "time"))
    p = PAR_PARAMS

    R1, T1 = shapes["replica"]
    R2, T2, n_micro = shapes["time"]
    d, R3, T3 = shapes["mv"]
    R5, T5, chunk = shapes["hgf"]
    y1, y2 = random_walk(R1, T1, 30), random_walk(R2, T2, 31)
    arrays = mv_model_arrays(d)
    y3 = mv_data(R3, T3, d, seed=33)
    u5 = hgf_data(R5, T5, "walk", seed=34)
    rows1 = slice(rank * R1 // world, (rank + 1) * R1 // world)
    rows5 = slice(rank * R5 // world, (rank + 1) * R5 // world)
    cols = {T: slice(rank * T // world, (rank + 1) * T // world) for T in (T2, T3)}
    hgf = models.HGF()
    track_sets = {"filter only": (), "all five": ALL5}

    def whole(a):
        return torch.from_numpy(a).to(dev)

    stage("meshes and inputs")
    # Single-device port results on the whole inputs, outside the counted run.
    ref = {"replica": ops.lgssm_smooth_fused(whole(y1), **p),
           "evidence sum": models.LGSSM(**p).log_evidence(whole(y1)).sum(),
           "mv": models.MvLGSSM.from_arrays(*arrays).smooth(whole(y3), method="blocked")}
    for prior in (None, PAR_PRIOR):
        ref["time", prior] = ops.lgssm_smooth_scan(whole(y2), **p, prior=prior)
    for name, tracks in track_sets.items():
        ref["hgf", name] = hgf.filter(whole(u5), method="fused", tracks=tracks)

    b1 = parallel.shard_replicas(y1, rmesh)
    b2, b3 = (parallel.shard(a, by_time) for a in (y2, y3))
    b5 = parallel.shard_replicas(u5, rmesh)
    chunks = [np.ascontiguousarray(u5[rows5, i:i + chunk]) for i in range(0, T5, chunk)]
    delta_ok = torch.zeros(b1.shape[0], device=dev)
    delta_nan = delta_ok.clone()
    if rank == 0:
        delta_nan[-1] = math.nan

    # The profiles of the paths of few kernels come before those of tens of
    # thousands (after which the profiler may record no kernel for a while).
    paths = {
        "replica-sharded lgssm_smooth_fused": (rmesh, lambda: ops.lgssm_smooth_fused(b1, **p)),
        "all_converged": (rmesh, lambda: (parallel.all_converged(delta_ok, 1e-6, rmesh),
                                          parallel.all_converged(delta_nan, 1e-6, rmesh))),
    }
    for name, tracks in track_sets.items():
        paths[f"replica-sharded HGF.filter fused, {name}"] = (
            rmesh, lambda tracks=tracks: hgf.filter(b5, method="fused", tracks=tracks))
    paths.update({
        "global_sum of the log evidence": (rmesh, lambda: parallel.global_sum(
            models.LGSSM(**p).log_evidence(b1), rmesh)),
        "time-sharded, no prior": (tmesh, lambda: parallel.lgssm_smooth_time_sharded(
            b2, **p, mesh=tmesh)),
        "time-sharded, prior": (tmesh, lambda: parallel.lgssm_smooth_time_sharded(
            b2, **p, mesh=tmesh, prior=PAR_PRIOR)),
        "vector time-sharded": (tmesh, lambda: parallel.mv_lgssm_smooth_time_sharded(
            b3, *arrays[:4], arrays[4:], mesh=tmesh)),
        "pipelined": (tmesh, lambda: parallel.lgssm_smooth_pipelined(
            b2, **p, mesh=tmesh, n_micro=n_micro)),
    })

    def streamed():
        state = models.HGFState(*(parallel.shard_replicas(a, rmesh)
                                  for a in hgf.init_state((R5,), device=dev)))
        session = parallel.StreamingSession(
            lambda st, c: hgf.filter(c, state=st, tracks=()), state, device=dev)
        for c in chunks:
            session.push(c)
        return session.flush()

    paths["replica-sharded HGF streaming"] = (rmesh, streamed)

    if dev.type == "cuda":
        torch.cuda.synchronize()
    stage("single-device references")
    for key in kernels.LAUNCHES:
        kernels.LAUNCHES[key] = 0
    outs = {name: fn() for name, (_, fn) in paths.items()}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    stage("main path")

    checks = []

    def check(path, against, tol, pairs, **extra):
        errs = {field: check_close(f"rank {rank}: {path} {field} vs {against}", got, want, tol)
                for field, got, want in pairs}
        checks.append({"path": path, "against": against, "tol": tol, **extra,
                       "max_abs_err": errs})

    def scalar_pairs(out, want, rows=slice(None), cols_=slice(None)):
        return [("mean", out.mean, want.mean[rows, cols_]),
                ("variance", out.variance, want.variance[rows, cols_])]

    out = outs["replica-sharded lgssm_smooth_fused"]
    check("replica-sharded lgssm_smooth_fused", "single-device K1", PAR_TOL["replica"],
          scalar_pairs(out, ref["replica"], rows1))
    sm, sv = numpy_rts(y1[rows1][:n_ref], **p)
    check("replica-sharded lgssm_smooth_fused", "float64 RTS", PAR_F64_TOL["replica"],
          [("mean", out.mean[:n_ref], sm), ("variance", out.variance[:n_ref], sv)],
          replicas=n_ref)
    check("global_sum of the log evidence", "single-device sum", PAR_TOL["replica"],
          [("total", outs["global_sum of the log evidence"], ref["evidence sum"])])
    converged = [bool(v) for v in outs["all_converged"]]
    if converged != [True, False]:
        raise SmokeFailure(f"rank {rank}: all_converged gave {converged}, not [True, False] "
                           "(a NaN on rank 0 is a violation everywhere)")
    checks.append({"path": "all_converged", "against": "[True, False]", "got": converged})

    for prior in (None, PAR_PRIOR):
        path = f"time-sharded, {'prior' if prior else 'no prior'}"
        out = outs[path]
        check(path, "single-device scan", PAR_TOL["time"],
              scalar_pairs(out, ref["time", prior], cols_=cols[T2]))
        sm, sv = numpy_rts(y2[:n_ref], **p, prior=prior)
        check(path, "float64 RTS", PAR_F64_TOL["time"],
              [("mean", out.mean[:n_ref], sm[:, cols[T2]]),
               ("variance", out.variance[:n_ref], sv[:, cols[T2]])], replicas=n_ref)

    out = outs["pipelined"]
    check("pipelined", "single-device scan", PAR_TOL["pipelined"],
          scalar_pairs(out, ref["time", None], cols_=cols[T2]), n_micro=n_micro)
    sm, sv = numpy_rts(y2[:n_ref], **p)
    check("pipelined", "float64 RTS", PAR_F64_TOL["pipelined"],
          [("mean", out.mean[:n_ref], sm[:, cols[T2]]),
           ("variance", out.variance[:n_ref], sv[:, cols[T2]])], replicas=n_ref)

    out = outs["vector time-sharded"]
    check("vector time-sharded", "single-device blocked", PAR_TOL["mv"],
          [("mean", out.mean, ref["mv"].mean[:, cols[T3]]),
           ("cov", out.cov, ref["mv"].cov[:, cols[T3]])], d=d)
    *_, sm, sP = numpy_kalman_mv(y3[:n_ref], *arrays)
    check("vector time-sharded", "float64 RTS", PAR_F64_TOL["mv"],
          [("mean", out.mean[:n_ref], sm[:, cols[T3]]),
           ("cov", out.cov[:n_ref], np.broadcast_to(sP[cols[T3]], (n_ref, T3 // world, d, d)))],
          d=d, replicas=n_ref)

    want_finals, want_tracks, _ = numpy_hgf(u5[rows5][:n_ref])
    for name, tracks in track_sets.items():
        path = f"replica-sharded HGF.filter fused, {name}"
        finals, traj = outs[path]
        single = ref["hgf", name]
        traj, single_traj = dict(zip(ALL5, traj)), dict(zip(ALL5, single[1]))
        pairs = [(f"final {f}", g, w[rows5]) for f, g, w in zip(ALL5, finals, single[0])]
        pairs += [(f"track {f}", traj[f], single_traj[f][rows5]) for f in tracks]
        check(path, "single-device K4", PAR_TOL["hgf"], pairs)
        pairs = [(f"final {f}", g[:n_ref], w) for f, g, w in zip(ALL5, finals, want_finals)]
        pairs += [(f"track {f}", traj[f][:n_ref], want_tracks[f]) for f in tracks]
        check(path, "float64 numpy HGF", PAR_F64_TOL["hgf"], pairs, replicas=n_ref)
    single = ref["hgf", "filter only"][0]
    check("replica-sharded HGF streaming", "single-device K4", PAR_TOL["hgf"],
          [(f, g, w[rows5]) for f, g, w in zip(ALL5, outs["replica-sharded HGF streaming"],
                                                single)], chunks=len(chunks))

    stage("checks")

    times = {}
    if timed:
        flush = torch.ones(64 * 2**20 // 4, device=dev)  # 64 MB, beyond the 50 MB L2
        # The time-sharded path's exchange alone: an all_gather of one filter
        # element (5 fields of R2 floats) with nothing queued before it.
        element = torch.ones(5 * R2, device=dev)
        paths["all_gather of one element alone"] = (
            tmesh, lambda: parallel.all_gather(element, tmesh, "time"))
        for name, (mesh, fn) in paths.items():
            times[name] = _rank_times(torch, fn, mesh, flush, runs=PAR_RUNS.get(name, 3))
        stage("times")
    return {"rank": rank, "world": world, "backend": torch.distributed.get_backend(),
            "device": str(dev), "shapes": shapes, "checks": checks, "launches": launches,
            "times": times, "seconds": seconds}


def parallel_parity_rank(torch, device: str, workdir) -> dict:
    """The body of one rank of the parity world of tests/test_torch_parallel.py:
    every entry point of the parallel layer on the inputs that the test wrote
    to ``workdir/inputs.npz``.  Saves this rank's output blocks to
    ``workdir/rank<r>.pt``, for the test to hold against the JAX package, and
    returns the meshes' shapes, the messages of the ValueErrors raised and
    the collectives each call made."""
    from cortex_tpu_torch import compile as port_compile, core, dists, models, ops, parallel

    P, NamedSharding = parallel.P, parallel.NamedSharding
    rank = torch.distributed.get_rank()
    data = {k: torch.from_numpy(v) for k, v in np.load(workdir / "inputs.npz").items()}
    blocks, info = {}, {"errors": {}}

    def error(name, fn):
        try:
            fn()
        except ValueError as e:
            info["errors"][name] = str(e)

    rmesh = parallel.make_mesh(device=device)
    two = parallel.make_mesh([("replica", 2), ("time", -1)], device=device)
    tmesh = parallel.make_mesh([("time", -1)], device=device)
    half = parallel.make_mesh([("replica", 2)], device=device)
    info["meshes"] = {"default": rmesh.shape, "two axes": two.shape, "two axes coords": two.coords,
                      "half": None if half is None else half.shape}
    error("two -1 axes", lambda: parallel.make_mesh([("a", -1), ("b", -1)], device=device))
    error("too large", lambda: parallel.make_mesh([("a", 16)], device=device))
    error("-1 does not divide", lambda: parallel.make_mesh([("a", 3), ("b", -1)], device=device))
    by_time = NamedSharding(tmesh, P(None, "time"))

    def collectives(mesh, fn):
        """``fn()`` and the collectives it made."""
        before = mesh.stats.calls
        value = fn()
        info.setdefault("collectives", {})[fn.__name__] = mesh.stats.calls - before
        return value

    y = parallel.shard_replicas(data["replica_y"], rmesh)
    blocks["replica mean"] = models.LGSSM(A=0.95, Q=0.5, H=1.0, R=1.0).smooth(y).mean
    blocks["replica K1 mean"] = ops.lgssm_smooth_fused(y, A=0.95, Q=0.5).mean
    info["gather is the whole"] = bool(torch.equal(
        parallel.gather(y, parallel.replica_sharding(rmesh)), data["replica_y"]))
    blocks["psum total"] = parallel.global_sum(
        models.LGSSM().log_evidence(parallel.shard_replicas(data["psum_y"], rmesh)), rmesh)

    y = parallel.shard(data["time_y"], by_time)
    for tag, prior in (("no prior", None), ("prior", (0.5, 2.0))):
        def time_sharded(prior=prior):
            return parallel.lgssm_smooth_time_sharded(y, A=0.9, Q=0.3, H=1.0, R=1.5,
                                                      mesh=tmesh, prior=prior)

        out = collectives(tmesh, time_sharded)
        blocks[f"time {tag} mean"], blocks[f"time {tag} variance"] = out
    error("ragged time split", lambda: parallel.shard(torch.ones(2, 62), by_time))
    y = parallel.shard(data["combined_y"], NamedSharding(two, P("replica", "time")))
    blocks["combined mean"] = parallel.lgssm_smooth_time_sharded(y, mesh=two).mean

    n, R = data["bernoulli"].shape
    graph = core.BipartiteFactorGraph()
    p = graph.add_variable(core.Variable(name="p"))
    for i in range(n):
        o = graph.add_variable(core.Variable(name="o", index=(i,)))
        f = graph.add_factor(core.Factor(functional_form="bernoulli"))
        graph.add_edge(p, f, core.Connection(label="out"))
        graph.add_edge(o, f, core.Connection(label="out"))

    class BetaBernoulliBatched(port_compile.BatchedProcessor):
        def compute_message_to_variable(self, engine, variants, dep_values):
            return dists.Beta(1.0 + dep_values[0], 2.0 - dep_values[0])

    compiled = port_compile.CompiledInference(core.InferenceEngine(model_engine=graph), [p],
                                              BetaBernoulliBatched())
    stacked = parallel.shard(data["bernoulli"], NamedSharding(rmesh, P(None, "replica")))
    marginals, _ = compiled.run({s: stacked[i] for i, s in enumerate(compiled.schedule.sources)})
    blocks["bernoulli a"], blocks["bernoulli b"] = marginals[p].a, marginals[p].b

    x = parallel.shard_replicas(torch.arange(64.0), rmesh)
    info["arange sum"] = float(parallel.global_sum(x, rmesh))
    deltas = torch.full((64,), 1e-8)
    info["converged"] = [bool(parallel.all_converged(parallel.shard_replicas(d, rmesh), 1e-6,
                                                     rmesh))
                         for d in (deltas, deltas.index_fill(0, torch.tensor([13]), 0.5),
                                   deltas.index_fill(0, torch.tensor([40]), math.nan))]

    prior = (data["mv_m0"], data["mv_P0"])
    y = parallel.shard(data["mv_y"], by_time)

    def mv_time_sharded():
        return parallel.mv_lgssm_smooth_time_sharded(
            y, data["mv_A"], data["mv_Q"], data["mv_H"], data["mv_R"], prior, mesh=tmesh)

    blocks["mv mean"], blocks["mv cov"] = collectives(tmesh, mv_time_sharded)
    y = parallel.shard(data["mvc_y"], by_time)
    args = (data["mvc_A"], data["mvc_Q"], data["mvc_H"], data["mvc_R"],
            (data["mvc_m0"], data["mvc_P0"]))
    blocks["mvc mean"], blocks["mvc cov"] = parallel.mv_lgssm_smooth_time_sharded(
        y, *args, mesh=tmesh, missing="component")
    error("bogus missing", lambda: parallel.mv_lgssm_smooth_time_sharded(
        y, *args, mesh=tmesh, missing="bogus"))

    y = parallel.shard(data["pipe_y"], by_time)
    for tag, prior, n_micro in (("no prior", None, None), ("prior", (0.5, 2.0), 2)):
        def pipelined(prior=prior, n_micro=n_micro):
            return parallel.lgssm_smooth_pipelined(y, A=0.9, Q=0.3, H=1.2, R=1.5, mesh=tmesh,
                                                   prior=prior, n_micro=n_micro)

        out = collectives(tmesh, pipelined)
        blocks[f"pipelined {tag} mean"], blocks[f"pipelined {tag} variance"] = out
    blocks["pipelined gaps mean"] = parallel.lgssm_smooth_pipelined(
        parallel.shard(data["pipe_nan_y"], by_time), A=0.95, Q=0.4, H=1.0, R=1.0,
        mesh=tmesh).mean
    error("ragged microbatch", lambda: parallel.lgssm_smooth_pipelined(
        parallel.shard(torch.ones(6, 64), by_time), mesh=tmesh))
    error("not (batch, T)", lambda: parallel.lgssm_smooth_pipelined(
        parallel.shard(torch.ones(64), NamedSharding(tmesh, P("time"))), mesh=tmesh))
    error("ragged stage split", lambda: parallel.shard(torch.ones(8, 62), by_time))

    hgf = models.HGF()
    u = parallel.shard_replicas(data["hgf_u"], rmesh)
    state = models.HGFState(*(parallel.shard_replicas(a, rmesh)
                              for a in hgf.init_state((64,), device=device)))
    final, _ = hgf.filter(u, state=state)
    blocks["hgf mu1"] = final.mu1
    session = parallel.StreamingSession(lambda st, c: hgf.filter(c, state=st, tracks=()),
                                        state, device=device)
    for i in range(0, u.shape[1], 10):
        session.push(u[:, i:i + 10])
    blocks["hgf streamed mu1"] = session.flush().mu1

    slds = models.SLDS(Pi=[[0.95, 0.05], [0.05, 0.95]], A=[0.98, 0.98], Q=[0.02, 2.0],
                       H=[1.0, 1.0], R=[0.1, 0.1], prior=(0.0, 1.0))
    beliefs = slds.filter(parallel.shard_replicas(data["slds_y"], rmesh))
    blocks["slds mean"], blocks["slds probs"] = beliefs.mean, beliefs.regime_probs
    blocks["slds loglik"] = beliefs.loglik

    torch.save({k: v.cpu() for k, v in blocks.items()}, workdir / f"rank{rank}.pt")
    return info


def phase_parallel_main_path(torch, card: str) -> dict:
    """The parallel main path in each world of PAR_WORLDS on the card, each
    rank a process of its own; returns {world: {"launches": summed over
    ranks, "seconds": s}}."""
    torch.cuda.empty_cache()
    base = Path(REPO) / "build" / "parallel"
    base.mkdir(parents=True, exist_ok=True)
    result = {}
    for backend, world in PAR_WORLDS:
        name = f"{backend} x{world}"
        start = time.perf_counter()
        # Every world in fresh processes: in this one, which has profiled the
        # earlier phases, torch.profiler lost kernel records of the first calls.
        ranks = run_parallel_ranks("parallel_main_path_rank", world,
                                   tempfile.mkdtemp(prefix=f"{backend}{world}_", dir=base),
                                   device="cuda", backend=backend)
        seconds = time.perf_counter() - start
        for r in ranks:
            for c in r["checks"]:
                emit(phase="parallel_main_path", world=name, rank=r["rank"], **c)
            for path, t in r["times"].items():
                emit(phase="parallel_times", world=name, rank=r["rank"], path=path, **t,
                     card=card)
            emit(phase="parallel_main_path", world=name, rank=r["rank"], launches=r["launches"],
                 seconds_to_join=r["seconds_to_join"], seconds=r["seconds"])
            # K1 on the replica block; K4 filter-only and with five tracks.
            if r["launches"]["lgssm_smooth"] < 1 or r["launches"]["hgf_filter"] < 2:
                raise SmokeFailure(f"{name}, rank {r['rank']}: the parallel main path launched "
                                   f"too few kernels: {r['launches']}")
        launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
        emit(phase="parallel_main_path", world=name, shapes=ranks[0]["shapes"],
             launches=launches, seconds=seconds)
        result[name] = {"launches": launches, "seconds": seconds}
    return result


# -- The switching and particle state-space models (phase 19) ---------------------------

# SLDS's IMM filter at 10,000 replicas x T=100 with tests/test_slds.py's
# two-regime model (calm and volatile); the Rao-Blackwellized particle filter
# at 1,024 replicas x 512 particles x 100 steps with K=1 (tests/test_rbpf.py's
# model) and K=2 (on the first 1,024 of the IMM's series); the bootstrap
# particle filter at 1,024 x 1,024 x 100 on tests/test_particle.py's linear
# model.
SSM_SHAPES = {"slds": (10_000, 100), "rbpf": (1024, 512, 100), "pf": (1024, 1024, 100)}
SLDS_TWO = {"Pi": [[0.97, 0.03], [0.03, 0.97]], "A": [0.98, 0.98], "Q": [0.02, 2.0],
            "H": [1.0, 1.0], "R": [0.1, 0.1], "prior": (0.0, 1.0)}
SLDS_ONE = {"Pi": [[1.0]], "A": [0.9], "Q": [0.4], "H": [1.0], "R": [0.6], "prior": (0.0, 2.0)}
PF_MODEL = {"A": 0.9, "Q": 0.3, "H": 1.0, "R": 0.5}
PF_INIT_VAR = 10.0  # the particles' spread before the first transition
# Bars.  The float32 IMM against the float64 numpy IMM on N_RTS replicas:
# atol = rtol = 1e-4 (tests/test_slds.py's K=1 bar).  RBPF with K=1 against
# the exact (float64) Kalman filter: evidence rtol 1e-4, ESS = N rtol 1e-4,
# means rtol 1e-4 atol 1e-5 (tests/test_rbpf.py:15-33).  RBPF with K=2
# against the IMM: |log evidence difference| < 8 on every replica, the mean
# |difference| of p(regime 2) < 0.1 (tests/test_rbpf.py:46-63).  The
# particle filter against the Kalman filter, with the bars of
# tests/test_particle.py:25-52, which holds one series at 20,000 particles:
# mean |mean error| < 0.05; |log evidence error| < 1.5 and the least ESS
# above 5% of N, held here on the 99th percentile and the median of 1,024
# replicas at 1,024 particles.  Their tails pass those bars at a 3-sigma
# observation (on the CPU at this width, seeds 0-2: the 99th percentile
# 1.08-1.19, the largest 1.39-2.24; the median least ESS 74-80, the 1st
# percentile 10-12).  The IMM picks the true regime of 80% of the steps
# (tests/test_slds.py:66).
SSM_TOL = {"imm": 1e-4, "rbpf_k1": (1e-5, 1e-4), "rbpf_imm_evidence": 8.0,
           "rbpf_imm_probs": 0.1, "pf_mean": 0.05, "pf_evidence_q99": 1.5,
           "pf_ess_median": 0.05, "imm_accuracy": 0.8}


def numpy_imm(y, Pi, A, Q, H, R, prior, w0=None):
    """Float64 IMM filter over the rows of ``y`` (n, T) (K = 1: the exact
    Kalman filter).  Returns ``(mean, variance, regime_probs, loglik)``:
    (n, T), (n, T), (n, T, K), (n,)."""
    y = np.asarray(y, np.float64)
    Pi, A, Q, H, R = (np.asarray(a, np.float64) for a in (Pi, A, Q, H, R))
    n, T = y.shape
    K = A.shape[0]
    logw = np.log(np.full((n, K), 1.0 / K) if w0 is None else np.broadcast_to(w0, (n, K)))
    m, v = np.full((n, K), float(prior[0])), np.full((n, K), float(prior[1]))
    means, varis, probs = np.empty((n, T)), np.empty((n, T)), np.empty((n, T, K))

    def update(m, v, obs, logw):
        s = H * H * v + R
        ll = -0.5 * (np.log(2.0 * math.pi * s) + (obs[:, None] - H * m) ** 2 / s)
        g = v * H / s
        m, v = m + g * (obs[:, None] - H * m), v - g * H * v
        joint = logw + ll
        step = _logsumexp(joint, -1)
        return m, v, joint - step[:, None], step

    loglik = np.zeros(n)
    with np.errstate(divide="ignore"):
        log_Pi = np.log(Pi)
    for t in range(T):
        if t:
            log_joint = logw[:, :, None] + log_Pi
            logw = _logsumexp(log_joint, 1)
            mu = np.exp(log_joint - logw[:, None, :])
            m0 = np.einsum("nkj,nk->nj", mu, m)
            v0 = np.einsum("nkj,nk->nj", mu, v) + np.einsum(
                "nkj,nkj->nj", mu, (m[:, :, None] - m0[:, None, :]) ** 2)
            m, v = A * m0, A * A * v0 + Q
        m, v, logw, step = update(m, v, y[:, t], logw)
        loglik += step
        w = np.exp(logw)
        means[:, t] = np.sum(w * m, -1)
        varis[:, t] = np.sum(w * (v + (m - means[:, t, None]) ** 2), -1)
        probs[:, t] = w
    return means, varis, probs, loglik


def _slds_arrays(params: dict) -> dict:
    return {k: (np.asarray(v, np.float32) if k != "prior" else v) for k, v in params.items()}


def _pf_transition(torch):
    A, Q = PF_MODEL["A"], PF_MODEL["Q"]

    def transition(generator, x):
        return A * x + Q ** 0.5 * torch.randn(x.shape, generator=generator, device=x.device,
                                             dtype=x.dtype)

    return transition


def _pf_log_lik(y_t, x):
    H, R = PF_MODEL["H"], PF_MODEL["R"]
    return -0.5 * ((y_t - H * x) ** 2 / R + math.log(2.0 * math.pi * R))


def ssm_paths(torch, models, device, shapes=SSM_SHAPES, seed: int = 0) -> dict:
    """The models, inputs and calls of the state-space phase on ``device``:
    {"calls": {name: fn}, "inputs": {...}}; the data come from a generator
    seeded with ``seed``."""
    from cortex_tpu_torch import convert

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    two = convert.slds_from_numpy(_slds_arrays(SLDS_TWO), device=device)
    one = convert.slds_from_numpy(_slds_arrays(SLDS_ONE), device=device)
    R, T = shapes["slds"]
    regimes, _, y = two.sample(gen, T, (R,))
    Rr, N, Tr = shapes["rbpf"]
    y_one = torch.from_numpy(random_walk(Rr, Tr, seed + 1)).to(device)
    Rp, Np, Tp = shapes["pf"]
    _, y_pf = models.LGSSM(**PF_MODEL).sample(gen, Tp, (Rp,))
    init = PF_INIT_VAR ** 0.5 * torch.randn((Rp, Np), generator=gen, device=device)
    transition = _pf_transition(torch)
    calls = {
        "SLDS.filter": lambda: two.filter(y),
        "rbpf_filter K=1": lambda: models.rbpf_filter(gen, one, y_one, n_particles=N),
        "rbpf_filter K=2": lambda: models.rbpf_filter(gen, two, y[:Rr, :Tr], n_particles=N),
        "particle_filter": lambda: models.particle_filter(
            gen, y_pf, transition, _pf_log_lik, init, batch_ndim=1),
    }
    return {"calls": calls, "inputs": {"regimes": regimes, "y": y, "y_one": y_one,
                                       "y_pf": y_pf}}


def run_ssm_main_path(torch, models, device, shapes=SSM_SHAPES, n_ref: int = N_RTS,
                      seed: int = 0) -> list:
    """Drive the switching and particle state-space models once on ``device``
    through their entry points, and check every result against its float64
    reference or its Monte-Carlo bar (SSM_TOL).  Returns the checks."""
    paths = ssm_paths(torch, models, device, shapes, seed)
    outs = {name: fn() for name, fn in paths["calls"].items()}
    if device != "cpu":
        torch.cuda.synchronize()
    inputs = paths["inputs"]
    y, regimes = inputs["y"], inputs["regimes"]
    Rr, N, Tr = shapes["rbpf"]
    Rp, Np, Tp = shapes["pf"]
    checks = []

    imm = outs["SLDS.filter"]
    two = _slds_arrays(SLDS_TWO)
    ref = numpy_imm(_host64(y[:n_ref]), **{k: v for k, v in two.items()})
    tol = SSM_TOL["imm"]
    checks.append({"path": "SLDS.filter", "against": "float64 numpy IMM", "tol": tol,
                   "replicas": n_ref, "max_abs_err": {
                       f: check_close(f"SLDS.filter {f}", g[:n_ref], w, tol)
                       for f, g, w in zip(imm._fields, imm, ref)}})
    accuracy = float((imm.regime_probs.argmax(-1) == regimes).float().mean())
    if not accuracy > SSM_TOL["imm_accuracy"]:
        raise SmokeFailure(f"SLDS.filter picked the true regime at {accuracy} of the steps")
    checks.append({"path": "SLDS.filter", "against": "the sampled regimes",
                   "accuracy": accuracy, "bar": SSM_TOL["imm_accuracy"]})

    one = _slds_arrays(SLDS_ONE)
    rb1 = outs["rbpf_filter K=1"]
    mean, _, _, loglik = numpy_imm(_host64(inputs["y_one"]), **one)
    atol, rtol = SSM_TOL["rbpf_k1"]
    checks.append({"path": "rbpf_filter K=1", "against": "float64 Kalman filter",
                   "atol": atol, "rtol": rtol, "particles": N, "max_abs_err": {
                       "log_evidence": check_close("rbpf K=1 log_evidence", rb1.log_evidence,
                                                   loglik, 0.0, rtol),
                       "mean": check_close("rbpf K=1 mean", rb1.mean, mean, atol, rtol),
                       "ess": check_close("rbpf K=1 ess", rb1.ess, np.full(rb1.ess.shape, N),
                                          0.0, rtol)}})

    rb2 = outs["rbpf_filter K=2"]
    evidence_gap = _host64(rb2.log_evidence - imm.loglik[:Rr])
    probs_gap = float((rb2.regime_probs[..., 1] - imm.regime_probs[:Rr, :Tr, 1]).abs().mean())
    check_close("rbpf K=2 regime_probs sum", rb2.regime_probs.sum(-1),
                np.ones(rb2.regime_probs.shape[:-1]), 0.0, 1e-4)
    if not (np.abs(evidence_gap).max() < SSM_TOL["rbpf_imm_evidence"]
            and probs_gap < SSM_TOL["rbpf_imm_probs"]):
        raise SmokeFailure(f"rbpf_filter K=2 against the IMM: evidence gap up to "
                           f"{np.abs(evidence_gap).max()}, regime gap {probs_gap}")
    checks.append({"path": "rbpf_filter K=2", "against": "SLDS.filter (IMM)",
                   "particles": N, "bars": [SSM_TOL["rbpf_imm_evidence"],
                                            SSM_TOL["rbpf_imm_probs"]],
                   "max_abs_evidence_gap": float(np.abs(evidence_gap).max()),
                   "mean_evidence_gap": float(evidence_gap.mean()),
                   "mean_regime_prob_gap": probs_gap})

    pf = outs["particle_filter"]
    A, Q, H, R = (PF_MODEL[k] for k in "AQHR")
    prior = (0.0, A * A * PF_INIT_VAR + Q)  # x_1 after one transition of the initial spread
    mean, _, _, loglik = numpy_imm(_host64(inputs["y_pf"]), [[1.0]], [A], [Q], [H], [R], prior)
    mean_err = float(np.abs(_host64(pf.means) - mean).mean())
    evidence_err = np.abs(_host64(pf.log_evidence) - loglik)
    evidence_q99 = float(np.quantile(evidence_err, 0.99))
    least_ess = _host64(pf.ess.min(-1).values)
    ess_median = float(np.median(least_ess))
    if not (pf.means.shape == (Rp, Tp) and mean_err < SSM_TOL["pf_mean"]
            and evidence_q99 < SSM_TOL["pf_evidence_q99"]
            and ess_median > SSM_TOL["pf_ess_median"] * Np):
        raise SmokeFailure(f"particle_filter against the Kalman filter: mean error {mean_err}, "
                           f"99th percentile of the evidence error {evidence_q99}, median "
                           f"least ESS {ess_median}")
    checks.append({"path": "particle_filter", "against": "float64 Kalman filter",
                   "particles": Np, "bars": [SSM_TOL["pf_mean"], SSM_TOL["pf_evidence_q99"],
                                             SSM_TOL["pf_ess_median"]],
                   "mean_abs_mean_err": mean_err, "q99_abs_evidence_err": evidence_q99,
                   "max_abs_evidence_err": float(evidence_err.max()),
                   "mean_evidence_err": float((_host64(pf.log_evidence) - loglik).mean()),
                   "median_least_ess": ess_median, "least_ess": float(least_ess.min())})
    return checks


def phase_ssm_main_path(torch, models, kernels, card: str) -> dict:
    """The state-space models at SSM_SHAPES on the card: the checks, K1-K4's
    counts over them (all 0), then each call's time (CUDA events), device
    time, kernels and the host's share; returns {path: ms}."""
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    checks = run_ssm_main_path(torch, models, "cuda")
    launches = _check_no_kernel_launched(kernels, "ssm_main_path")
    for check in checks:
        emit(phase="ssm_main_path", **check)
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    result = {}
    for name, fn in ssm_paths(torch, models, "cuda", seed=1)["calls"].items():
        ms = median_ms(torch, fn, flush, runs=2, warmup=0)  # the checks warmed them up
        count = _profile_once(torch, fn)
        if not count["kernels"]:  # a profile now and then holds no kernel record
            count = _profile_once(torch, fn)
        result[name] = ms
        emit(phase="ssm_times", path=name, shapes=SSM_SHAPES, ms=ms,
             device_ms=count["device_ms"], host_share=1.0 - count["device_ms"] / ms,
             kernels_per_call=count["kernels"], copies_per_call=count["copies"],
             top_kernels=count["top"], card=card)
    emit(phase="ssm_main_path", seconds=time.perf_counter() - start)
    return {"launches": launches, "times": result}


def main() -> None:
    import torch

    device = phase_device(torch)
    sys.path.insert(0, REPO)
    from cortex_tpu_torch import _build, models, ops, parallel
    from cortex_tpu_torch.models import HMM, LGSSM
    from cortex_tpu_torch.ops import kernels, kernels_hgf, kernels_hmm

    phase_build(kernels, _build)
    worst = {"lgssm_smooth": phase_kernel(torch, kernels), **phase_hmm_kernel(torch, kernels_hmm),
             "hgf_filter": phase_hgf_kernel(torch, kernels_hgf)}
    launches = {"lgssm_smooth": phase_main_path(torch, LGSSM, ops, kernels),
                **phase_hmm_main_path(torch, HMM, ops, kernels),
                "hgf_filter": phase_hgf_main_path(torch, models, ops, parallel, kernels)}
    times = phase_times(torch, LGSSM, ops, device["nvidia_smi"])
    hmm_times = phase_hmm_times(torch, HMM, kernels_hmm, device["nvidia_smi"])
    hgf_times = phase_hgf_times(torch, models, kernels_hgf, device["nvidia_smi"])["all five f32"]
    phase_generic_main_path(torch, LGSSM, ops, kernels)
    phase_generic_times(torch, LGSSM, ops, device["nvidia_smi"])
    phase_gmm_main_path(torch, models, ops, kernels)
    phase_gmm_times(torch, models, device["nvidia_smi"])
    phase_mv_main_path(torch, models, ops, kernels)
    phase_mv_times(torch, models, device["nvidia_smi"])
    worlds = phase_parallel_main_path(torch, device["nvidia_smi"])
    phase_ssm_main_path(torch, models, kernels, device["nvidia_smi"])
    # Each kernel's launches over every run of a main path that launches it.
    by_phase = {name: {"main path": count, **{
        f"parallel_main_path {world}": run["launches"][name] for world, run in worlds.items()}}
        for name, count in launches.items()}
    hmm_source = "cortex_tpu_torch/csrc/hmm_forward_backward.cu"
    print(json.dumps({"kernels": [
        {
            "name": "lgssm_smooth",
            "route": "cuda",
            "source": "cortex_tpu_torch/csrc/lgssm_smooth.cu",
            "replaces": "cortex_tpu/ops/pallas_kernels.py:99",
            "launches": sum(by_phase["lgssm_smooth"].values()),
            "launches_by_phase": by_phase["lgssm_smooth"],
            "max_abs_err": worst["lgssm_smooth"],
            "ms": times[R_MAIN]["kernel device"] or times[R_MAIN]["kernel"],
            "plain_ms": times[R_MAIN]["plain"],
            # y read once, mean and variance written once; ~8 operations a
            # replica-step.
            **_bound(12 * R_MAIN * T_MAIN + 12 * T_MAIN, 8 * R_MAIN * T_MAIN),
            "library_ms": times[R_MAIN]["library device"] or times[R_MAIN]["library"],
        },
        *({
            "name": name,
            "route": "cuda",
            "source": hmm_source,
            "replaces": replaces,
            "launches": sum(by_phase[name].values()),
            "launches_by_phase": by_phase[name],
            "max_abs_err": worst[name],
            "ms": hmm_times[HMM_R][f"{name} device"] or hmm_times[HMM_R][name],
            "plain_ms": hmm_times[HMM_R][f"{name} plain"],
            **hmm_bound(HMM_R, HMM_T, HMM_K, counts=name == "hmm_fb_counts"),
            "library_ms": None,  # no one PyTorch call computes a scaled forward-backward
        } for name, replaces in (("hmm_fb", "cortex_tpu/ops/pallas_hmm.py:158"),
                                 ("hmm_fb_counts", "cortex_tpu/ops/pallas_hmm.py:202"))),
        {
            "name": "hgf_filter",
            "route": "cuda",
            "source": "cortex_tpu_torch/csrc/hgf_filter.cu",
            "replaces": "cortex_tpu/ops/pallas_hgf.py:349",
            "launches": sum(by_phase["hgf_filter"].values()),
            "launches_by_phase": by_phase["hgf_filter"],
            "max_abs_err": worst["hgf_filter"],
            # The main path's call: all five tracks in float32.
            "ms": hgf_times["kernel device"] or hgf_times["kernel"],
            "plain_ms": hgf_times["plain"],
            **hgf_bound(HGF_R, HGF_T, 5, 4),
            "library_ms": None,  # no one PyTorch call computes an HGF filter
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["name"], "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
