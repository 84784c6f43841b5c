"""Drive the PyTorch port's main paths once on an NVIDIA GPU: LGSSM, HMM, HGF,
the generic compiled path, the Gaussian mixtures, the vector chains, the
parallel layer, the switching and particle state-space models, the rest
of the model zoo, and serving (CUDA graphs, exported programs, checkpoints,
diagnostics, the native signal core).

Run from the root of a checkout, with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX: its references are a float64 numpy RTS smoother,
a float64 numpy log-space forward-backward, a float64 numpy HGF, float64
numpy VB-GMMs, a float64 numpy vector Kalman filter and RTS smoother, a
float64 numpy IMM filter, float64 numpy EKF/UKF, GaBP (a dense solve), NIG,
EP, GP, SGPR, PPCA and BOCPD, and the port's own plain versions, CPU runs and
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
    ``StreamingSession`` over 8 chunks), replica-sharded GaBP grids and
    chain-sharded HMC (``sharded_zoo``); holds every block to the
    single-device port path and to float64 numpy (the chains, joined by
    ``gather``, to their target's moments); counts K1's and K4's launches;
    and times each path (call, device, collectives).
19. ``ssm_main_path`` and ``ssm_times``: ``SLDS`` at 10,000 x 100 against a
    float64 numpy IMM, ``rbpf_filter`` at 1,024 x 512 x 100 (K=1 against the
    exact Kalman evidence, K=2 against the IMM), ``particle_filter`` at 1,024
    x 1,024 x 100 against the Kalman filter within its Monte-Carlo bars;
    K1-K4's counts (all 0); each call's time, device time and kernels.
20. ``zoo_main_path``: the rest of the zoo at ZOO_SHAPES: ``NonlinearSSM``
    (the pendulum, 10,000 x 100, EKF and UKF) against float64 numpy EKF/UKF
    and the CPU, linear f, h against the float64 RTS; ``gabp_grid_solve`` and
    ``gabp_solve`` (256 grids of 64 x 64) against a dense solve and each
    other; ``hmc_sample`` (1,024 chains, d=64) against its target's moments;
    the GLMs, EP and CVI at 100,000 x 32 against float64 NIG, EP and the
    exact posterior, or the CPU; ``BayesianAR`` (10,000 x 1,000) against
    float64 NIG and ``latent_ar_smooth`` against the RTS; ``GP``, ``SGPR``
    (65,536 x 256), ``GPClassifier`` and ``GPSSM`` against float64 numpy, the
    exact GP or the CPU; PPCA and FA (65,536 x 128); BOCPD (4,096 x 1,000,
    r_max 256) against float64 numpy and the CPU; K1-K4's counts (all 0).
21. ``zoo_times``: each zoo path's call time (CUDA events), device time,
    kernels and host share from one profiled call, and its top kernels;
    GPSSM also at T=10,000 (call time only).
22. ``serve_main_path``: ``serve.BucketedServer`` over ``lgssm_smooth_fused``
    (K1) at T=100 with every bucket from 8 to 16,384 replicas captured into a
    CUDA graph up front, and over ``HMM.smooth(method="fused")`` (K3) and
    ``hmm_forward_backward_fused`` (K2) at ``ladder.hmm`` (buckets 8 to 4,096);
    each request's answer equal to the eager call and within the float64 RTS
    and forward-backward bars; one captured launch a bucket and the kernel's
    name in a profiled replay (in a fresh process); ``export_serialized`` of K1's server function
    at 10,000 x 100 (one kernel node) loaded in a fresh process that imports
    only ``cortex_tpu_torch.ops``; two fresh processes sharing one
    ``enable_persistent_cache`` directory (the first builds, the second
    loads); the HGF stream at ``ladder.hgf`` checkpointed after 4 of its 8
    chunks, restored and resumed bit for bit; ``ConvergenceMonitor`` over
    ``GMM.fit`` at ``ladder.gmm`` and ``check_finite``; ``rhat`` and ``ess`` of
    AR(1) draws on the card against float64 numpy.
23. ``serve_times``: each bucket's replayed call against the eager call at
    its size (call and device time, host share), the host time of a K1
    replay's parts (check, copy in, replay, copies out), and the native
    against the Python signal core's fan-out on the host (the native must
    be faster).

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


def queued_ms(torch, fn, flush, runs: int = 25, warmup: int = 3,
              sleep_cycles: int = 2_000_000) -> float:
    """Median device time of ``fn`` in ms, host time left out: each call is
    enqueued behind the read of ``flush`` and a sleep of ``sleep_cycles`` on
    the card (about 1 ms), so the host has enqueued the whole call before the
    device reaches the events around it.  For calls too short for the
    profiler to record reliably."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush.sum()
        torch.cuda._sleep(sleep_cycles)
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
    "gabp": (256, 64, 64, 80),  # grids, H, W, iterations (ZOO_SHAPES')
    "hmc": (1024, 64, 200, 200, 8),  # chains, d, warmup, samples, leapfrog steps
}
PAR_PARAMS = {"A": 0.9, "Q": 0.3, "H": 1.0, "R": 1.5}
PAR_PRIOR = (0.5, 2.0)
# atol = rtol of each sharded path against the single-device port path on
# the same card: the JAX tests' own bars (tests/test_parallel.py: replica-
# sharded 1e-5, time-sharded 1e-3, pipelined 1e-4, vector time-sharded 2e-3;
# tests/test_hgf.py: 1e-5).  Against float64 numpy: K1's main-path bar 2e-4,
# 1e-3 for the chains of 1,024 steps, 2e-3 for the vector chains, HGF_F64_TOL.
PAR_TOL = {"replica": 1e-5, "time": 1e-3, "pipelined": 1e-4, "mv": 2e-3, "hgf": 1e-5,
           "gabp": 1e-5}
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
            "all_gather of one element alone": 10, "chain-sharded HMC": 1}
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


def sharded_zoo(torch, rmesh, shapes, seed: int = 40) -> dict:
    """Phase 18's GaBP and HMC on this rank of the replica mesh: GaBP on the
    rank's block of ``shapes["gabp"]``'s grids and HMC on its share of
    ``shapes["hmc"]``'s chains (a generator seeded with ``seed`` plus the
    rank).  Returns {"single": the single-device GaBP on the whole grids,
    "paths": {path: fn}, "check": outs -> checks, "blocks": outs -> {name:
    block}}; the check joins every rank's chains (``gather``) and holds
    their pooled moments to the target's (check_hmc)."""
    from cortex_tpu_torch import ops, parallel

    dev, rank, world = rmesh.device, rmesh.coords["replica"], rmesh.shape["replica"]
    R, H, W, n_iters = shapes["gabp"]
    C, d, n_warm, n_samp, n_leap = shapes["hmc"]
    rng = np.random.default_rng(seed)
    lam = torch.from_numpy((4.0 + 0.5 * rng.random((H, W))).astype(np.float32)).to(dev)
    eta = rng.normal(size=(R, H, W)).astype(np.float32)
    rows = slice(rank * R // world, (rank + 1) * R // world)
    block = parallel.shard_replicas(eta, rmesh)
    mu, cov = hmc_target(d)
    mu_t = torch.tensor(mu, dtype=torch.float32, device=dev)
    prec = torch.tensor(np.linalg.inv(cov), dtype=torch.float32, device=dev)
    if C % world:
        raise ValueError(f"{C} chains must divide evenly over {world} ranks")

    def log_density(x):
        r = x - mu_t
        return -0.5 * r @ (prec @ r)

    def hmc():
        gen = torch.Generator(device=dev).manual_seed(seed + rank)
        return ops.hmc_sample(gen, log_density, torch.zeros((C // world, d), device=dev),
                              n_samples=n_samp, n_warmup=n_warm, n_leapfrog=n_leap,
                              n_chains=C // world)

    single = ops.gabp_grid_solve(lam, torch.from_numpy(eta).to(dev), -0.8, n_iters=n_iters)
    paths = {"replica-sharded gabp_grid_solve": lambda: ops.gabp_grid_solve(
        lam, block, -0.8, n_iters=n_iters), "chain-sharded HMC": hmc}

    def check(outs):
        grid = outs["replica-sharded gabp_grid_solve"]
        by_replica = parallel.replica_sharding(rmesh)
        errs = {f: check_close(f"rank {rank}: replica-sharded gabp_grid_solve {f}", g, w,
                               PAR_TOL["gabp"])
                for f, g, w in (("mean", grid.mean, single.mean[rows]),
                                ("variance", grid.variance, single.variance))}
        res = outs["chain-sharded HMC"]
        joined = [parallel.gather(x.contiguous(), by_replica)
                  for x in (res.samples, res.accept_rate, res.step_size)]
        return [{"path": "replica-sharded gabp_grid_solve", "against": "single-device GaBP",
                 "tol": PAR_TOL["gabp"], "grids": R, "max_abs_err": errs},
                {**check_hmc(*joined, d, f"rank {rank}: chain-sharded HMC"),
                 "path": "chain-sharded HMC", "chains_per_rank": C // world}]

    def blocks(outs):
        res = outs["chain-sharded HMC"]
        return {"gabp lam": lam, "gabp eta": block,
                "gabp mean": outs["replica-sharded gabp_grid_solve"].mean,
                "hmc samples": res.samples, "hmc accept": res.accept_rate}

    return {"single": single, "paths": paths, "check": check, "blocks": blocks}


def zoo_sharded_rank(torch, device: str, workdir, shapes) -> dict:
    """The body of one rank of the world of tests/test_torch_gabp_hmc.py:
    :func:`sharded_zoo` at ``shapes`` on a replica mesh over the world.
    Saves this rank's blocks to ``workdir/rank<r>.pt`` for the test to hold
    against the JAX package, and returns its checks."""
    from cortex_tpu_torch import parallel

    rmesh = parallel.make_mesh([("replica", -1)], device=device)
    zoo = sharded_zoo(torch, rmesh, shapes)
    outs = {name: fn() for name, fn in zoo["paths"].items()}
    checks = zoo["check"](outs)
    rank = torch.distributed.get_rank()
    torch.save({k: v.cpu() for k, v in zoo["blocks"](outs).items()}, workdir / f"rank{rank}.pt")
    return {"rank": rank, "checks": checks}


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
    zoo = sharded_zoo(torch, rmesh, shapes)

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
    paths.update({name: (rmesh, fn) for name, fn in zoo["paths"].items()})

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
    checks += zoo["check"](outs)

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


# Phases 20-21: the rest of the model zoo at full width.  NLSSM: the pendulum
# of docs/models.md (d=2, m=1), R x T; GaBP: R grids of H x W (the size
# ops/gabp.py names), n iterations; HMC: chains on a d-dimensional correlated
# Gaussian with the docs' settings; EP, CVI, the GLMs: n points x d; AR: R
# series x T, p lags, and the latent AR at R x T (ladder.mv's d=4); GPs: n
# points (SGPR with m inducing points), GPSSM at T and timed at a longer T;
# PPCA/FA: n x d, q components, EM iterations; BOCPD: R x T, r_max.
ZOO_SHAPES = {
    "nlssm": (10_000, 100),
    "gabp": (256, 64, 64, 80),
    "hmc": (1024, 64, 200, 200, 8),  # chains, d, warmup, samples, leapfrog steps
    "glm": (100_000, 32),
    "ar": (10_000, 1000, 4),
    "latent_ar": (4096, 100),
    "gp": 4096,
    "sgpr": (65_536, 256),
    "gpc": 4096,
    "gpssm": (4096, 10_000),
    "ppca": (65_536, 128, 8, 100),
    "bocpd": (4096, 1000, 256),
}
# What the references see: float64 numpy on the first rows (replicas, series,
# grids), and the port's own CPU run at a size the host takes.  The float64
# GP behind the GPSSM conditions on all T points and predicts at every 4th
# (its n x n triangular solve costs seconds a kernel at T=4,096).
ZOO_REF = {"nlssm": 64, "nlssm_cpu": 256, "gabp": 16, "ar": 256, "latent_ar": 64,
           "cpu_n": 4096, "gpc_cpu": 1024, "bocpd": 16, "bocpd_cpu": 64, "gpssm_stride": 4}
# Bars (atol, rtol), each from the JAX test of the path:
# - NLSSM on the card against its CPU run, and linear f, h against the float64
#   RTS: tests/test_nlssm.py's 1e-5, 1e-4; the nonlinear pendulum against a
#   float64 EKF/UKF: its EKF-UKF agreement bar, 1e-4, 1e-3 (float32 over 100
#   steps of a nonlinear map); log evidence rtol 1e-4, and atol 1e-5 a
#   step (a sum of T terms of either sign can be near 0).
# - GaBP against the dense solve and grid against edge list: tests/
#   test_gabp.py's loopy bar, 2e-5, 2e-4.
# - HMC: the pooled mean and covariance within 5 Monte-Carlo standard errors
#   (the spread of the 1,024 chains' own moments over sqrt(1,024)), plus 0.02
#   for the bias of finite chains; acceptance in (0.4, 1] (docs/models.md).
# - NIG (BayesianLinearRegression, BayesianAR): tests/test_glm.py's and
#   tests/test_ar.py's: mean 1e-3, cov_scale (1e-6, 1e-2), a rtol 1e-6, b rtol
#   1e-2; the log evidence rtol 1e-4 (tests/test_ar.py's decomposition).
# - EP against float64 numpy EP: tests/test_ep.py's Gaussian-site bars, mean
#   (1e-5, 1e-4), cov (1e-5, 1e-3).  CVI's one rho=1 step against the exact
#   posterior: tests/test_cvi.py's, mean 1e-3, cov (1e-4, 1e-2).
# - The card against the port's CPU run on the same inputs (iterative float32
#   paths: logistic CVI, Poisson EP, GPC, FA, BOCPD): 1e-4, 1e-3.
# - The latent AR against the float64 RTS: the associative smoother's bar at
#   d=4 (MV_TOL["assoc"]).
# - GP, SGPR predictions and GPSSM against float64 and the exact GP: tests/
#   test_gp.py's and tests/test_gp_ssm.py's: mean (1e-4, 1e-3), variance
#   (1e-4, 1e-2) (GP) and (1e-4, 2e-3) (GPSSM); the LML rtol 1e-4.  The SGPR
#   bound is a difference of terms of the size of yᵀy/σ² (~4e5 here):
#   within 1e-5 of that size.
# - PPCA's closed form: tests/test_ppca.py's sigma2 rtol 1e-4, log likelihood
#   rtol 1e-5; W Wᵀ (1e-4, 1e-3); EM's subspace against the closed form's:
#   projectors within 5e-3; EM traces non-decreasing up to float32 rounding of
#   the sum (1e-6 of its size, tests/test_ppca.py's -0.5 at its n·d).
# - BOCPD against float64 numpy: tests/test_bocpd.py's 2e-3 on the log
#   run-length probabilities of non-negligible mass (above -25) and on the
#   changepoint probabilities; the log evidence rtol 1e-5.
ZOO_TOL = {"nlssm_cpu": (1e-5, 1e-4), "nlssm_linear": (1e-5, 1e-4), "nlssm_f64": (1e-4, 1e-3),
           "evidence": 1e-4, "gabp": (2e-5, 2e-4), "hmc_se": 5.0, "hmc_bias": 0.02,
           "hmc_accept": 0.4, "nig_mean": (1e-3, 1e-3), "nig_cov": (1e-6, 1e-2),
           "nig_a": 1e-6, "nig_b": 1e-2, "ep_mean": (1e-5, 1e-4), "ep_cov": (1e-5, 1e-3),
           "cvi_mean": (1e-3, 1e-3), "cvi_cov": (1e-4, 1e-2), "cpu": (1e-4, 1e-3),
           "gp_mean": (1e-4, 1e-3), "gp_var": (1e-4, 1e-2), "gpssm_var": (1e-4, 2e-3),
           "ppca_sigma2": 1e-4, "ppca_ll": 1e-5, "ppca_wwt": (1e-4, 1e-3), "projector": 5e-3,
           "monotone": 1e-6, "bocpd": (2e-3, 2e-3), "bocpd_evidence": 1e-5, "bound": 1e-5,
           "evidence_step": 1e-5}
ZOO_DT = 0.05  # the pendulum's time step (docs/models.md)
ZOO_PENDULUM = {"Q": 0.01 * np.eye(2), "R": np.array([[0.05]]), "m0": np.array([0.5, 0.0]),
                "P0": 0.1 * np.eye(2)}
ZOO_LINEAR = {"A": np.array([[1.0, 0.1], [0.0, 0.9]]), "H": np.array([[1.0, 0.5]]),
              "Q": 0.2 * np.eye(2), "R": np.array([[0.5]]), "m0": np.array([0.4, 0.0]),
              "P0": np.diag([1.3, 0.7])}
ZOO_AR = np.array([0.5, -0.2, 0.1, 0.05])  # stable AR(4) coefficients
ZOO_GP = {"lengthscale": 1.0, "variance": 1.0, "noise": 0.1}
# Phase 21 times a call three times (CUDA events, median), once where the
# checked run took longer than ZOO_SLOW_MS, and keeps the checked run's time
# past ZOO_KEEP_MS (HMC, GPSSM: seconds of host work a call, where a first
# call's start-up is a small share), then profiles one call.
ZOO_SLOW_MS = 250.0
ZOO_KEEP_MS = 2000.0


def _pendulum_numpy():
    """The pendulum's f, its Jacobian, h and its Jacobian on (..., 2) states,
    float64."""
    g, dt = 9.81, ZOO_DT

    def f(x):
        return np.stack([x[..., 0] + dt * x[..., 1], x[..., 1] - dt * g * np.sin(x[..., 0])], -1)

    def F(x):
        one, zero = np.ones_like(x[..., 0]), np.zeros_like(x[..., 0])
        return np.stack([np.stack([one, dt * one], -1),
                         np.stack([-dt * g * np.cos(x[..., 0]), one], -1)], -2)

    def h(x):
        return np.sin(x[..., :1])

    def Hj(x):
        return np.stack([np.cos(x[..., 0]), np.zeros_like(x[..., 0])], -1)[..., None, :]

    return f, F, h, Hj


def _pendulum_torch(torch):
    g, dt = 9.81, ZOO_DT

    def f(x):
        return torch.stack([x[0] + dt * x[1], x[1] - dt * g * torch.sin(x[0])])

    def h(x):
        return torch.sin(x[:1])

    return f, h


def pendulum_series(R: int, T: int, seed: int):
    """``(R, T, 1)`` float32 observations of the pendulum simulated in float64."""
    rng = np.random.default_rng(seed)
    f, _, h, _ = _pendulum_numpy()
    p = ZOO_PENDULUM
    x = p["m0"] + rng.normal(size=(R, 2)) @ np.linalg.cholesky(p["P0"]).T
    ys = np.empty((R, T, 1))
    for t in range(T):
        if t:
            x = f(x) + rng.normal(size=(R, 2)) @ np.linalg.cholesky(p["Q"]).T
        ys[:, t] = h(x) + rng.normal(size=(R, 1)) * math.sqrt(p["R"][0, 0])
    return ys.astype(np.float32)


def numpy_nlssm(y, f, F, h, Hj, Q, R, m0, P0, method: str, smooth: bool,
                alpha=1.0, beta=2.0, kappa=0.0, jitter=1e-9):
    """Float64 EKF or UKF (Merwe weights) filter, and RTS smoother when
    ``smooth``, over the series of ``y`` (n, T, m) with callables on (..., d)
    states.  Returns ``(mean (n, T, d), cov (n, T, d, d), loglik (n,))``."""
    y = np.asarray(y, np.float64)
    n, T, m = y.shape
    d = len(m0)
    lam = alpha * alpha * (d + kappa) - d
    c = d + lam
    wm = np.full(2 * d + 1, 1.0 / (2.0 * c))
    wm[0] = lam / c
    wc = wm.copy()
    wc[0] += 1.0 - alpha * alpha + beta

    def transform(fn, mean, P):
        """Mean, covariance and cross-covariance of ``fn`` at ``N(mean, P)``."""
        if method == "ekf":
            J = (F if fn is f else Hj)(mean)
            return fn(mean), J @ P @ np.swapaxes(J, -1, -2), P @ np.swapaxes(J, -1, -2)
        L = np.linalg.cholesky(P + jitter * np.eye(d))
        off = math.sqrt(c) * np.swapaxes(L, -1, -2)
        pts = np.concatenate([mean[:, None], mean[:, None] + off, mean[:, None] - off], 1)
        out = fn(pts)
        mu = np.einsum("s,nsd->nd", wm, out)
        do, di = out - mu[:, None], pts - mean[:, None]
        return (mu, np.einsum("s,nsi,nsj->nij", wc, do, do),
                np.einsum("s,nsi,nsj->nij", wc, di, do))

    mean, P = np.broadcast_to(m0, (n, d)).astype(np.float64), np.broadcast_to(P0, (n, d, d))
    ms, Ps, steps, ll = [], [], [], np.zeros(n)
    for t in range(T):
        if t:
            mp, Pp, C = transform(f, mean, P)
            Pp = Pp + Q
            steps.append((mp, Pp, C))
            mean, P = mp, Pp
        yh, S, Cxy = transform(h, mean, P)
        S = S + R
        S_inv = np.linalg.inv(S)
        v = y[:, t] - yh
        K = Cxy @ S_inv
        mean = mean + np.einsum("nij,nj->ni", K, v)
        P = P - K @ S @ np.swapaxes(K, -1, -2)
        ll -= 0.5 * (m * math.log(2.0 * math.pi) + np.linalg.slogdet(S)[1]
                     + np.einsum("ni,nij,nj->n", v, S_inv, v))
        ms.append(mean)
        Ps.append(P)
    if smooth:
        for t in range(T - 2, -1, -1):
            mp, Pp, C = steps[t]
            G = C @ np.linalg.inv(Pp)
            ms[t] = ms[t] + np.einsum("nij,nj->ni", G, ms[t + 1] - mp)
            Ps[t] = Ps[t] + G @ (Ps[t + 1] - Pp) @ np.swapaxes(G, -1, -2)
    return np.stack(ms, 1), np.stack(Ps, 1), ll


def grid_precision(lam_diag, lam_off: float):
    """The dense float64 precision of a 4-neighbor grid of node precisions
    ``lam_diag`` (H, W) and uniform coupling."""
    H, W = lam_diag.shape
    idx = np.arange(H * W).reshape(H, W)
    Lam = np.diag(np.asarray(lam_diag, np.float64).ravel())
    for a, b in ((idx[:, :-1], idx[:, 1:]), (idx[:-1, :], idx[1:, :])):
        Lam[a.ravel(), b.ravel()] = Lam[b.ravel(), a.ravel()] = lam_off
    return Lam


def hmc_target(d: int):
    """A correlated Gaussian: mean from -1 to 1, correlation 0.5^|i-j|,
    scales from 0.5 to 2.  Returns ``(mean, cov)`` in float64."""
    mean = np.linspace(-1.0, 1.0, d)
    s = np.linspace(0.5, 2.0, d)
    idx = np.arange(d)
    return mean, s[:, None] * 0.5 ** np.abs(idx[:, None] - idx[None, :]) * s[None, :]


def numpy_nig(X, t, prior_scale=100.0, a0=2.0, b0=1.0):
    """Float64 Normal-Inverse-Gamma posterior of ``t = X w + noise`` (batched
    over leading axes): ``(mean, cov_scale, a, b, log_evidence)``."""
    from scipy.special import gammaln

    X, t = np.asarray(X, np.float64), np.asarray(t, np.float64)
    n, d = X.shape[-2:]
    prec = np.eye(d) / prior_scale + np.swapaxes(X, -1, -2) @ X
    V = np.linalg.inv(prec)
    mean = np.einsum("...ij,...j->...i", V, np.einsum("...ni,...n->...i", X, t))
    a = a0 + 0.5 * n
    b = b0 + 0.5 * (np.einsum("...n,...n->...", t, t)
                    - np.einsum("...i,...ij,...j->...", mean, prec, mean))
    log_ev = (-0.5 * n * math.log(2.0 * math.pi)
              + 0.5 * (-d * math.log(prior_scale) - np.linalg.slogdet(prec)[1])
              + a0 * math.log(b0) - a * np.log(b) + gammaln(a) - gammaln(a0))
    return mean, V, np.full(b.shape, a), b, log_ev


def numpy_ep_probit(X, y, n_iters, damping: float, prior_var=1.0, tau_floor=1e-8):
    """Float64 parallel EP with probit sites, the iteration of
    ops/ep.py::ep_linear_model, run to the largest of ``n_iters`` (a tuple
    of iteration counts).  Returns {count: (mean, cov)} after each count."""
    from scipy.special import log_ndtr

    X, y = np.asarray(X, np.float64), np.asarray(y, np.float64)
    n, d = X.shape

    def posterior(tau, nu):
        L = np.linalg.cholesky(np.eye(d) / prior_var + X.T @ (tau[:, None] * X))
        S = np.linalg.inv(L).T @ np.linalg.inv(L)
        m = S @ (X.T @ nu)
        return m, S, np.sum((X @ S) * X, axis=1)

    tau, nu = np.full(n, tau_floor), np.zeros(n)
    out = {}
    for it in range(max(n_iters) + 1):
        if it in n_iters:
            out[it] = posterior(tau, nu)[:2]
        if it == max(n_iters):
            return out
        m, _, sigma2 = posterior(tau, nu)
        tau_cav = np.maximum(1.0 / sigma2 - tau, tau_floor)
        nu_cav = X @ m / sigma2 - nu
        mu_cav, var_cav = nu_cav / tau_cav, 1.0 / tau_cav
        s = np.sqrt(1.0 + var_cav)
        z = y * mu_cav / s
        ratio = np.exp(-0.5 * z * z - 0.5 * math.log(2.0 * math.pi) - log_ndtr(z))
        mt = mu_cav + y * var_cav * ratio / s
        vt = np.maximum(var_cav - var_cav**2 * ratio * (z + ratio) / (1.0 + var_cav), 1e-10)
        tau = (1.0 - damping) * tau + damping * np.maximum(1.0 / vt - tau_cav, tau_floor)
        nu = (1.0 - damping) * nu + damping * (mt / vt - nu_cav)


def _numpy_kernel(name: str, a, b, lengthscale, variance):
    r2 = np.sum((np.asarray(a, np.float64)[:, None] - np.asarray(b, np.float64)[None]) ** 2, -1)
    if name == "rbf":
        return variance * np.exp(-0.5 * r2 / lengthscale**2)
    z = math.sqrt(3.0 if name == "matern32" else 5.0) * np.sqrt(r2 + 1e-12) / lengthscale
    if name == "matern32":
        return variance * (1.0 + z) * np.exp(-z)
    return variance * (1.0 + z + z * z / 3.0) * np.exp(-z)


def numpy_gp(X, y, Xs, kernel="rbf", lengthscale=1.0, variance=1.0, noise=0.1, jitter=1e-6):
    """Float64 exact GP: ``(mean, variance)`` at ``Xs`` and the log marginal
    likelihood."""
    from scipy.linalg import cho_solve, solve_triangular

    y = np.asarray(y, np.float64)
    n = len(y)
    K = _numpy_kernel(kernel, X, X, lengthscale, variance) + (noise + jitter) * np.eye(n)
    L = np.linalg.cholesky(K)
    alpha = cho_solve((L, True), y)
    Ks = _numpy_kernel(kernel, X, Xs, lengthscale, variance)
    v = solve_triangular(L, Ks, lower=True)
    lml = -0.5 * y @ alpha - np.log(np.diag(L)).sum() - 0.5 * n * math.log(2.0 * math.pi)
    return Ks.T @ alpha, np.maximum(variance - np.sum(v * v, 0), 1e-12), lml


def numpy_sgpr(X, y, Z, Xs, lengthscale=1.0, variance=1.0, noise=0.1, jitter=1e-6):
    """Float64 collapsed SGPR bound (RBF) and its predictive ``(mean,
    variance)`` at ``Xs``."""
    from scipy.linalg import solve_triangular

    y = np.asarray(y, np.float64)
    n, m = len(y), len(Z)
    sigma = math.sqrt(noise)
    L = np.linalg.cholesky(_numpy_kernel("rbf", Z, Z, lengthscale, variance)
                           + jitter * (1.0 + variance) * np.eye(m))
    A = solve_triangular(L, _numpy_kernel("rbf", Z, X, lengthscale, variance), lower=True) / sigma
    LB = np.linalg.cholesky(np.eye(m) + A @ A.T)
    c = solve_triangular(LB, A @ y / sigma, lower=True)
    elbo = (-0.5 * n * math.log(2.0 * math.pi * noise) - np.log(np.diag(LB)).sum()
            - 0.5 * y @ y / noise + 0.5 * c @ c - 0.5 * (n * variance / noise - np.sum(A * A)))
    t1 = solve_triangular(L, _numpy_kernel("rbf", Z, Xs, lengthscale, variance), lower=True)
    t2 = solve_triangular(LB, t1, lower=True)
    var = variance - np.sum(t1 * t1, 0) + np.sum(t2 * t2, 0)
    return elbo, t2.T @ c, np.maximum(var, 1e-12)


def numpy_bocpd(y, model: str, hazard=0.01, r_max=256):
    """Float64 BOCPD truncated at ``r_max`` as models/bocpd.py computes it,
    with the default priors (NIG: mu0 0, kappa0 1, alpha0 1, beta0 1; Beta:
    1, 1), over the rows of ``y`` (n, T).  Returns ``(run-length log
    probabilities (n, T, r_max), changepoint probabilities (n, T), log
    evidence (n,))``."""
    from scipy.special import gammaln, logsumexp

    y = np.asarray(y, np.float64)
    n, T = y.shape
    R = r_max
    logw = np.full((n, R), -np.inf)
    logw[:, 0] = 0.0
    stats = [np.zeros((n, R)) for _ in range(3 if model == "gaussian" else 2)]
    out, log_Z = np.empty((n, T, R)), np.zeros(n)
    for t in range(T):
        yt = y[:, t, None]
        if model == "gaussian":
            cnt, s, q = stats
            kappa = 1.0 + cnt
            delta = s / kappa
            alpha = 1.0 + 0.5 * cnt
            beta = 1.0 + 0.5 * (q - s * delta)
            nu, scale2 = 2.0 * alpha, beta * (kappa + 1.0) / (alpha * kappa)
            pred = (gammaln(0.5 * (nu + 1.0)) - gammaln(0.5 * nu)
                    - 0.5 * np.log(nu * math.pi * scale2)
                    - 0.5 * (nu + 1.0) * np.log1p((yt - delta) ** 2 / scale2 / nu))
            upd = [cnt + 1.0, s + yt, q + yt * yt]
        else:
            ones, zeros = stats
            p1 = (1.0 + ones) / (2.0 + ones + zeros)
            pred = np.where(yt > 0.5, np.log(p1), np.log1p(-p1))
            upd = [ones + yt, zeros + 1.0 - yt]
        joint = logw + pred
        grow = joint + math.log1p(-hazard)
        log_joint = np.concatenate([logsumexp(joint + math.log(hazard), -1)[:, None],
                                    grow[:, : R - 2],
                                    np.logaddexp(grow[:, -2:-1], grow[:, -1:])], -1)
        step = logsumexp(log_joint, -1)
        logw = log_joint - step[:, None]
        out[:, t], log_Z = logw, log_Z + step
        keep = grow[:, -1:] > grow[:, -2:-1]
        stats = [np.concatenate([np.zeros((n, 1)), u[:, : R - 2],
                                 np.where(keep, u[:, -1:], u[:, -2:-1])], -1) for u in upd]
    return out, np.exp(out[..., 0]) + np.exp(out[..., 1]), log_Z


def check_hmc(samples, accept_rate, step_size, d: int, name: str) -> dict:
    """Hold HMC draws ``samples`` (chains, draws, d) of :func:`hmc_target` to
    its mean and covariance within ZOO_TOL's Monte-Carlo bars, and the
    acceptance rates to (0.4, 1]; raise SmokeFailure otherwise."""
    mu, cov = hmc_target(d)
    draws = _host64(samples)
    C = draws.shape[0]
    pooled = draws.reshape(-1, d).mean(0)
    se_mean = draws.mean(1).std(0) / math.sqrt(C)
    centered = draws - pooled
    second = np.einsum("csi,csj->cij", centered, centered) / draws.shape[1]
    pooled_cov = second.mean(0)
    se_cov = second.std(0) / math.sqrt(C)
    scale = np.sqrt(np.outer(np.diag(cov), np.diag(cov)))
    z_mean = np.abs(pooled - mu) / (ZOO_TOL["hmc_se"] * se_mean + ZOO_TOL["hmc_bias"])
    z_cov = np.abs(pooled_cov - cov) / (ZOO_TOL["hmc_se"] * se_cov + ZOO_TOL["hmc_bias"] * scale)
    accept = _host64(accept_rate)
    if not (np.isfinite(draws).all() and z_mean.max() <= 1.0 and z_cov.max() <= 1.0
            and accept.min() > ZOO_TOL["hmc_accept"] and accept.max() <= 1.0):
        raise SmokeFailure(f"{name}: mean {z_mean.max()}, cov {z_cov.max()} of their bars, "
                           f"acceptance {accept.min()}..{accept.max()}")
    return {"against": "the target's mean and covariance", "chains": C,
            "max_mean_err": float(np.abs(pooled - mu).max()),
            "max_cov_err": float(np.abs(pooled_cov - cov).max()),
            "worst_share_of_bar": [float(z_mean.max()), float(z_cov.max())],
            "accept_rate": [float(accept.min()), float(accept.mean())],
            "step_size": [float(_host64(step_size).min()), float(_host64(step_size).max())]}


def zoo_data(shapes=ZOO_SHAPES, seed: int = 0) -> dict:
    """Every input of the zoo phases as float32 numpy arrays, from ``seed``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    data = {}
    R, T = shapes["nlssm"]
    data["pendulum"] = pendulum_series(R, T, seed + 1)
    data["linear"] = random_walk(R, T, seed + 2)[..., None]
    R, H, W, _ = shapes["gabp"]
    data["gabp_lam"] = (4.0 + 0.5 * rng.random((H, W))).astype(f32)
    data["gabp_eta"] = rng.normal(size=(R, H, W)).astype(f32)
    n, d = shapes["glm"]
    X = rng.normal(size=(n, d)) / math.sqrt(d)
    w = rng.normal(size=d) * 2.0
    data["X"] = X.astype(f32)
    data["y_lin"] = (X @ w + 0.5 * rng.normal(size=n)).astype(f32)
    data["y_probit"] = np.where(rng.random(n) < 0.5 * (1.0 + np.tanh(0.8 * (X @ w))), 1.0,
                                -1.0).astype(f32)
    data["y_count"] = rng.poisson(np.exp(0.5 * (X @ w))).astype(f32)
    R, T, p = shapes["ar"]
    y = np.zeros((R, T))
    for t in range(p, T):
        y[:, t] = y[:, t - p:t][:, ::-1] @ ZOO_AR + 0.3 * rng.normal(size=R)
    data["ar"] = y.astype(f32)
    R, T = shapes["latent_ar"]
    data["latent_ar"] = (y[:R, :T] + 0.5 * rng.normal(size=(R, T))).astype(f32)
    n = shapes["gp"]
    data["gp_x"] = np.sort(rng.uniform(0.0, 10.0, n)).astype(f32)[:, None]
    data["gp_y"] = (np.sin(data["gp_x"][:, 0]) + 0.3 * rng.normal(size=n)).astype(f32)
    n, m = shapes["sgpr"]
    data["sgpr_x"] = rng.uniform(0.0, float(m), n).astype(f32)[:, None]
    data["sgpr_y"] = (np.sin(data["sgpr_x"][:, 0]) + 0.3 * rng.normal(size=n)).astype(f32)
    data["sgpr_z"] = (np.arange(m) + 0.5).astype(f32)[:, None]
    n = shapes["gpc"]
    data["gpc_x"] = rng.normal(size=(n, 2)).astype(f32)
    data["gpc_y"] = np.where(np.sin(2.0 * data["gpc_x"][:, 0]) + 0.5 * data["gpc_x"][:, 1]
                             + 0.2 * rng.normal(size=n) > 0, 1.0, -1.0).astype(f32)
    n, n_long = shapes["gpssm"]
    t_long = np.cumsum(rng.uniform(0.01, 0.05, n_long))
    data["gpssm_t_long"] = t_long.astype(f32)
    data["gpssm_y_long"] = (np.sin(t_long) + 0.3 * rng.normal(size=n_long)).astype(f32)
    n, d, q, _ = shapes["ppca"]
    Wt = rng.normal(size=(d, q))
    Z = rng.normal(size=(n, q))
    data["ppca"] = (Z @ Wt.T + 0.7 * rng.normal(size=(n, d)) + 1.0).astype(f32)
    psi = rng.uniform(0.2, 1.5, d)
    data["fa"] = (Z @ Wt.T + np.sqrt(psi) * rng.normal(size=(n, d))).astype(f32)
    data["fa_init"] = (0.1 * rng.normal(size=(d, q))).astype(f32)
    R, T, _ = shapes["bocpd"]
    jumps = rng.random((R, T)) < 1.0 / 150.0
    level = np.cumsum(jumps * rng.normal(scale=3.0, size=(R, T)), -1)
    data["bocpd_gauss"] = (level + rng.normal(size=(R, T))).astype(f32)
    rate = 1.0 / (1.0 + np.exp(-np.cumsum(jumps * rng.normal(scale=2.0, size=(R, T)), -1)))
    data["bocpd_bern"] = (rng.random((R, T)) < rate).astype(f32)
    return data


def zoo_calls(torch, models, ops, device, data: dict, shapes=ZOO_SHAPES, seed: int = 0) -> dict:
    """The zoo's calls on ``device``, each a function of nothing, on ``data``
    (rows cut to what the arrays hold); the HMC chains and the default
    inits draw from generators seeded with ``seed``."""
    def t(name):
        return torch.from_numpy(data[name]).to(device)

    f, h = _pendulum_torch(torch)
    pend = models.NonlinearSSM(f, h, **{k: torch.tensor(v, dtype=torch.float32, device=device)
                                        for k, v in ZOO_PENDULUM.items()})
    lin = {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in ZOO_LINEAR.items()}
    A, H = lin["A"], lin["H"]
    linear = models.NonlinearSSM(lambda x: A @ x, lambda x: H @ x,
                                 lin["Q"], lin["R"], lin["m0"], lin["P0"])
    y_pend, y_lin = t("pendulum"), t("linear")
    calls = {}
    for method in ("ekf", "ukf"):
        calls[f"NonlinearSSM.filter {method}"] = lambda m=method: pend.filter(y_pend, method=m)
        calls[f"NonlinearSSM.smooth {method}"] = lambda m=method: pend.smooth(y_pend, method=m)
        calls[f"NonlinearSSM.log_evidence {method}"] = (
            lambda m=method: pend.log_evidence(y_pend, method=m))
        calls[f"linear NonlinearSSM.smooth {method}"] = (
            lambda m=method: linear.smooth(y_lin, method=m))

    *_, n_iters = shapes["gabp"]
    lam, eta = t("gabp_lam"), t("gabp_eta")
    Hg, Wg = lam.shape
    edges = ops.grid_edges(Hg, Wg)
    off = torch.full((len(edges),), -0.8, device=device)
    calls["gabp_grid_solve"] = lambda: ops.gabp_grid_solve(lam, eta, -0.8, n_iters=n_iters)
    calls["gabp_solve"] = lambda: ops.gabp_solve(lam.reshape(-1), eta.reshape(eta.shape[0], -1),
                                                  edges, off, n_iters=n_iters)

    C, d, n_warm, n_samp, n_leap = shapes["hmc"]
    mu_np, cov_np = hmc_target(d)
    mu = torch.tensor(mu_np, dtype=torch.float32, device=device)
    prec = torch.tensor(np.linalg.inv(cov_np), dtype=torch.float32, device=device)

    def log_density(x):
        r = x - mu
        return -0.5 * r @ (prec @ r)

    def hmc():
        gen = torch.Generator(device=device).manual_seed(seed)
        return ops.hmc_sample(gen, log_density, torch.zeros((C, d), device=device),
                              n_samples=n_samp, n_warmup=n_warm, n_leapfrog=n_leap, n_chains=C)

    calls["HMC"] = hmc

    X, y_lin_glm, y_probit, y_count = t("X"), t("y_lin"), t("y_probit"), t("y_count")
    calls["BayesianLinearRegression.fit"] = lambda: models.BayesianLinearRegression().fit(
        X, y_lin_glm)
    calls["ep_linear_model probit"] = lambda: ops.ep_linear_model(
        X, ops.probit_tilted_moments(y_probit))
    calls["EPClassifier probit"] = lambda: models.EPClassifier().fit(X, y_probit)

    def gaussian_log_lik(z):
        return -0.5 * (y_lin_glm[:, None] - z) ** 2 / 0.25 - 0.5 * math.log(2.0 * math.pi * 0.25)

    calls["cvi Gaussian, one step"] = lambda: ops.cvi_linear_model(
        X, gaussian_log_lik, n_iters=1, step_size=1.0)
    calls["cvi logistic"] = lambda: ops.cvi_linear_model(
        X, lambda z: torch.nn.functional.logsigmoid(y_probit[:, None] * z))
    calls["PoissonRegression.fit"] = lambda: models.PoissonRegression().fit(X, y_count)

    *_, p = shapes["ar"]
    y_ar, y_lat = t("ar"), t("latent_ar")
    calls["BayesianAR.fit"] = lambda: models.BayesianAR(p=p).fit(y_ar)
    coeffs = torch.tensor(ZOO_AR, dtype=torch.float32, device=device)
    calls["latent_ar_smooth"] = lambda: models.latent_ar_smooth(y_lat, coeffs, 0.09, 0.25)

    gp_x, gp_y = t("gp_x"), t("gp_y")
    xs = torch.linspace(0.0, 10.0, 512, device=device)[:, None]

    def gp():
        return models.GP(**ZOO_GP).fit(gp_x, gp_y).predict(xs)

    calls["GP.fit + predict"] = gp
    sgpr_x, sgpr_y, sgpr_z = t("sgpr_x"), t("sgpr_y"), t("sgpr_z")
    sgpr_xs = torch.linspace(0.0, float(sgpr_z.shape[0]), 512, device=device)[:, None]

    def sgpr():
        post = models.SGPR(**ZOO_GP).fit(sgpr_x, sgpr_y, sgpr_z)
        return (post.elbo, *post.predict(sgpr_xs))

    calls["SGPR.fit + predict"] = sgpr
    gpc_x, gpc_y = t("gpc_x"), t("gpc_y")

    def gpc():
        post = models.GPClassifier().fit(gpc_x, gpc_y)
        return (post.latent_mean, post.site_delta, post.predict_proba(gpc_x))

    calls["GPClassifier.fit"] = gpc
    n_gpssm = shapes["gpssm"][0]
    t_long, y_long = t("gpssm_t_long"), t("gpssm_y_long")
    for kern in ("matern32", "matern52"):
        model = models.GPSSM(kernel=kern, lengthscale=2.0, variance=1.0, noise=0.1)
        calls[f"GPSSM {kern}"] = lambda model=model: model.posterior(t_long[:n_gpssm],
                                                                    y_long[:n_gpssm])
        calls[f"GPSSM {kern} long"] = lambda model=model: model.posterior(t_long, y_long)

    *_, q, n_em = shapes["ppca"]
    Y, Y_fa, fa_init = t("ppca"), t("fa"), t("fa_init")
    calls["ppca_closed_form"] = lambda: models.ppca_closed_form(Y, q)
    calls["PPCA.fit_em"] = lambda: models.PPCA(q).fit_em(Y, n_iters=n_em)
    calls["FactorAnalysis.fit_em"] = lambda: models.FactorAnalysis(q).fit_em(
        Y_fa, n_iters=n_em, init=(fa_init, torch.ones(Y_fa.shape[1], device=device)))

    *_, r_max = shapes["bocpd"]
    y_g, y_b = t("bocpd_gauss"), t("bocpd_bern")
    calls["BOCPD GaussianNIG"] = lambda: models.BOCPD(r_max=r_max).filter(y_g)
    calls["BOCPD BernoulliBeta"] = lambda: models.BOCPD(models.BernoulliBeta(),
                                                        r_max=r_max).filter(y_b)
    return calls


def _rows(data: dict, cuts: dict) -> dict:
    """``data`` with the leading axis of the named arrays cut."""
    return {k: v[:cuts[k]] if k in cuts else v for k, v in data.items()}


def run_zoo_main_path(torch, models, ops, device, shapes=ZOO_SHAPES, refs=ZOO_REF,
                      seed: int = 0, data=None, times=None, stages=None) -> list:
    """Drive the rest of the zoo once on ``device`` through its entry points,
    and check each result against float64 numpy, the port's own CPU run on
    the first rows, or both (ZOO_TOL).  Returns the checks.  ``data``
    (zoo_data's) is made from ``seed`` when not given; on a card, ``times``
    (a dict) receives each call's time in ms (CUDA events), and ``stages``
    (a dict) the seconds of each stage."""
    clock = [time.perf_counter()]

    def stage(name):
        clock.append(time.perf_counter())
        if stages is not None:
            stages[name] = clock[-1] - clock[-2]

    data = zoo_data(shapes, seed) if data is None else data
    calls = zoo_calls(torch, models, ops, device, data, shapes, seed)
    stage("inputs")
    outs = {}
    for name, fn in calls.items():
        if name.endswith(" long"):
            continue  # timed in phase 21 only
        if times is None or device == "cpu":
            outs[name] = fn()
            continue
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        outs[name] = fn()
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end)
    if device != "cpu":
        torch.cuda.synchronize()
    stage("card calls")
    n_cpu = refs["cpu_n"]
    cpu_data = _rows(data, {"pendulum": refs["nlssm_cpu"], "X": n_cpu, "y_probit": n_cpu,
                            "y_count": n_cpu, "gpc_x": refs["gpc_cpu"],
                            "gpc_y": refs["gpc_cpu"], "fa": n_cpu,
                            "bocpd_gauss": refs["bocpd_cpu"], "bocpd_bern": refs["bocpd_cpu"]})
    cpu_names = [n for n in calls if n.startswith(("NonlinearSSM.filter", "NonlinearSSM.smooth",
                                                   "cvi logistic", "Poisson", "FactorAnalysis",
                                                   "BOCPD"))]
    cpu_calls = zoo_calls(torch, models, ops, "cpu", cpu_data, shapes, seed)
    cpu = {name: cpu_calls[name]() for name in cpu_names}
    small = {}  # the card's run on the CPU run's inputs, where the full one differs
    small_calls = zoo_calls(torch, models, ops, device, cpu_data, shapes, seed)
    for name in ("cvi logistic", "PoissonRegression.fit", "GPClassifier.fit",
                 "FactorAnalysis.fit_em"):
        small[name] = small_calls[name]()
    cpu["GPClassifier.fit"] = cpu_calls["GPClassifier.fit"]()
    stage("cpu runs")
    checks = []

    def check(path, against, tol, pairs, **extra):
        atol, rtol = tol if isinstance(tol, tuple) else (0.0, tol)
        errs = {field: check_close(f"{path} {field} vs {against}", got, want, atol, rtol)
                for field, got, want in pairs}
        checks.append({"path": path, "against": against, "atol": atol, "rtol": rtol, **extra,
                       "max_abs_err": errs})

    # NLSSM.  The log evidence sums T terms of either sign: rtol on the sum
    # and atol a step.
    f, F, h, Hj = _pendulum_numpy()
    evidence = (ZOO_TOL["evidence_step"] * data["pendulum"].shape[1], ZOO_TOL["evidence"])
    n_ref, n_cpu_nl = refs["nlssm"], refs["nlssm_cpu"]
    p = ZOO_PENDULUM
    for method in ("ekf", "ukf"):
        for sweep in ("filter", "smooth"):
            name = f"NonlinearSSM.{sweep} {method}"
            got = outs[name]
            want = numpy_nlssm(data["pendulum"][:n_ref], f, F, h, Hj, p["Q"], p["R"], p["m0"],
                               p["P0"], method, sweep == "smooth")
            check(name, "float64 numpy " + method.upper(), ZOO_TOL["nlssm_f64"],
                  [("mean", got.mean[:n_ref], want[0]), ("cov", got.cov[:n_ref], want[1])],
                  replicas=n_ref)
            check(name, "float64 numpy " + method.upper(), evidence,
                  [("loglik", got.loglik[:n_ref], want[2])], replicas=n_ref)
            check(name, "port on cpu", ZOO_TOL["nlssm_cpu"],
                  [(k, g[:n_cpu_nl], w) for k, g, w in zip(got._fields, got, cpu[name])],
                  replicas=n_cpu_nl)
        name = f"NonlinearSSM.log_evidence {method}"
        check(name, "filter().loglik", ZOO_TOL["nlssm_cpu"],
              [("loglik", outs[name], outs[f"NonlinearSSM.filter {method}"].loglik)])
        name = f"linear NonlinearSSM.smooth {method}"
        lin = ZOO_LINEAR
        _, _, ll, sm, sP = numpy_kalman_mv(data["linear"][:n_ref], lin["A"], lin["Q"], lin["H"],
                                           lin["R"], lin["m0"], lin["P0"])
        got = outs[name]
        check(name, "float64 RTS", ZOO_TOL["nlssm_linear"],
              [("mean", got.mean[:n_ref], sm), ("cov", got.cov[:n_ref],
                                                np.broadcast_to(sP, got.cov[:n_ref].shape))],
              replicas=n_ref)
        check(name, "float64 Kalman filter", evidence, [("loglik", got.loglik[:n_ref], ll)],
              replicas=n_ref)
    if outs["NonlinearSSM.smooth ukf"].mean.shape != data["pendulum"].shape[:2] + (2,):
        raise SmokeFailure("NonlinearSSM.smooth: wrong shape")

    stage("references: NLSSM")

    # GaBP.
    grid, edge = outs["gabp_grid_solve"], outs["gabp_solve"]
    n_g = refs["gabp"]
    from scipy.linalg import cho_factor, cho_solve

    eta = data["gabp_eta"][:n_g].reshape(n_g, -1).T.astype(np.float64)
    mean = cho_solve(cho_factor(grid_precision(data["gabp_lam"], -0.8), lower=True), eta)
    mean = mean.T.reshape(data["gabp_eta"][:n_g].shape)
    check("gabp_grid_solve", "float64 dense solve", ZOO_TOL["gabp"],
          [("mean", grid.mean[:n_g], mean)], grids=n_g)
    check("gabp_solve", "float64 dense solve", ZOO_TOL["gabp"],
          [("mean", edge.mean[:n_g].reshape(mean.shape), mean)], grids=n_g)
    check("gabp_solve", "gabp_grid_solve", ZOO_TOL["gabp"],
          [("mean", edge.mean, grid.mean.reshape(edge.mean.shape)),
           ("variance", edge.variance, grid.variance.reshape(-1))])
    if not (0 < float(grid.variance.min()) and float(grid.delta) < 1e-4):
        raise SmokeFailure(f"gabp_grid_solve did not converge: delta {float(grid.delta)}")

    stage("references: GaBP")

    # HMC.
    res = outs["HMC"]
    checks.append({**check_hmc(res.samples, res.accept_rate, res.step_size, shapes["hmc"][1],
                               "HMC"), "path": "HMC"})

    stage("references: HMC")

    # EP, CVI and the GLMs.
    X64 = data["X"].astype(np.float64)
    want = numpy_nig(data["X"], data["y_lin"])
    got = outs["BayesianLinearRegression.fit"]
    check("BayesianLinearRegression.fit", "float64 NIG", ZOO_TOL["nig_mean"],
          [("mean", got.mean, want[0])])
    check("BayesianLinearRegression.fit", "float64 NIG", ZOO_TOL["nig_cov"],
          [("cov_scale", got.cov_scale, want[1])])
    check("BayesianLinearRegression.fit", "float64 NIG", ZOO_TOL["nig_a"], [("a", got.a, want[2])])
    check("BayesianLinearRegression.fit", "float64 NIG", ZOO_TOL["nig_b"], [("b", got.b, want[3])])
    check("BayesianLinearRegression.fit", "float64 NIG", ZOO_TOL["evidence"],
          [("log_evidence", got.log_evidence, want[4])])
    ep = numpy_ep_probit(data["X"], data["y_probit"], (30, 40), 0.8)
    for name, n_iters in (("ep_linear_model probit", 30), ("EPClassifier probit", 40)):
        m, S = ep[n_iters]
        got = outs[name]
        check(name, "float64 numpy EP", ZOO_TOL["ep_mean"], [("mean", got.mean, m)],
              iterations=n_iters)
        check(name, "float64 numpy EP", ZOO_TOL["ep_cov"], [("cov", got.cov, S)],
              iterations=n_iters)
    S = np.linalg.inv(np.eye(X64.shape[1]) + X64.T @ X64 / 0.25)
    m = S @ (X64.T @ data["y_lin"].astype(np.float64)) / 0.25
    got = outs["cvi Gaussian, one step"]
    check("cvi Gaussian, one step", "exact posterior", ZOO_TOL["cvi_mean"], [("mean", got.mean, m)])
    check("cvi Gaussian, one step", "exact posterior", ZOO_TOL["cvi_cov"], [("cov", got.cov, S)])
    for name in ("cvi logistic", "PoissonRegression.fit"):
        got, want = small[name], cpu[name]
        pairs = [("mean", got.mean, want.mean), ("cov", got.cov, want.cov)]
        if name == "cvi logistic":
            pairs.append(("elbo_trace", got.elbo_trace, want.elbo_trace))
        check(name, "port on cpu", ZOO_TOL["cpu"], pairs, n=n_cpu)

    stage("references: GLMs, EP, CVI")

    # AR.
    n_ar = refs["ar"]
    *_, p_ar = shapes["ar"]
    y_ar = data["ar"][:n_ar]
    lags = np.stack([y_ar[:, p_ar - 1 - k: y_ar.shape[1] - 1 - k] for k in range(p_ar)], -1)
    want = numpy_nig(lags, y_ar[:, p_ar:])
    got = outs["BayesianAR.fit"]
    for field, i, tol in (("mean", 0, "nig_mean"), ("cov_scale", 1, "nig_cov"), ("a", 2, "nig_a"),
                          ("b", 3, "nig_b"), ("log_evidence", 4, "evidence")):
        check("BayesianAR.fit", "float64 NIG", ZOO_TOL[tol],
              [(field, getattr(got, field)[:n_ar], want[i])], series=n_ar)
    n_lat = refs["latent_ar"]
    p_lat = len(ZOO_AR)
    A_c = np.vstack([ZOO_AR, np.eye(p_lat)[:-1]])
    Q_c = np.zeros((p_lat, p_lat))
    Q_c[0, 0] = 0.09
    Q_c += 1e-9 * np.eye(p_lat)
    _, _, _, sm, sP = numpy_kalman_mv(data["latent_ar"][:n_lat, :, None], A_c, Q_c,
                                      np.eye(p_lat)[:1], [[0.25]], np.zeros(p_lat),
                                      10.0 * np.eye(p_lat))
    got = outs["latent_ar_smooth"]
    check("latent_ar_smooth", "float64 RTS", (MV_TOL["assoc"], MV_TOL["assoc"]),
          [("mean", got.mean[:n_lat], sm),
           ("cov", got.cov[:n_lat], np.broadcast_to(sP, got.cov[:n_lat].shape))], replicas=n_lat)

    stage("references: AR")

    # Gaussian processes.
    xs = np.linspace(0.0, 10.0, 512, dtype=np.float32)[:, None]
    mean, var, _ = numpy_gp(data["gp_x"], data["gp_y"], xs, **ZOO_GP)
    got = outs["GP.fit + predict"]
    check("GP.fit + predict", "float64 numpy GP", ZOO_TOL["gp_mean"], [("mean", got[0], mean)])
    check("GP.fit + predict", "float64 numpy GP", ZOO_TOL["gp_var"], [("variance", got[1], var)])
    m_ind = data["sgpr_z"].shape[0]
    sgpr_xs = np.linspace(0.0, float(m_ind), 512, dtype=np.float32)[:, None]
    elbo, mean, var = numpy_sgpr(data["sgpr_x"], data["sgpr_y"], data["sgpr_z"], sgpr_xs, **ZOO_GP)
    got = outs["SGPR.fit + predict"]
    # The bound is a difference of terms of the size of yᵀy/σ²: float32 holds
    # it to ZOO_TOL["bound"] of that size.
    yy = float(np.sum(np.square(data["sgpr_y"], dtype=np.float64))) / ZOO_GP["noise"]
    check("SGPR.fit + predict", "float64 collapsed bound", (ZOO_TOL["bound"] * yy, 0.0),
          [("elbo", got[0], elbo)])
    check("SGPR.fit + predict", "float64 collapsed bound", ZOO_TOL["gp_mean"],
          [("mean", got[1], mean)])
    check("SGPR.fit + predict", "float64 collapsed bound", ZOO_TOL["gp_var"],
          [("variance", got[2], var)])
    n_small = shapes["gp"]
    xb = torch.from_numpy(data["sgpr_x"][:n_small]).to(device)
    yb = torch.from_numpy(data["sgpr_y"][:n_small]).to(device)
    zb = torch.from_numpy(data["sgpr_z"]).to(device)
    bound = float(models.SGPR(**ZOO_GP).elbo(xb, yb, zb))
    lml = float(models.GP(**ZOO_GP).log_marginal_likelihood(xb, yb))
    if not bound <= lml + ZOO_TOL["evidence"] * abs(lml):
        raise SmokeFailure(f"SGPR bound {bound} above the exact LML {lml}")
    checks.append({"path": "SGPR.elbo", "against": "GP LML (a bound)", "n": n_small,
                   "elbo": bound, "lml": lml})
    latent, delta, proba = outs["GPClassifier.fit"]
    accuracy = float(((proba > 0.5).float() * 2 - 1 == torch.from_numpy(data["gpc_y"]).to(
        device)).float().mean())
    if not (float(delta) < 1e-3 and accuracy > 0.85 and torch.isfinite(latent).all()):
        raise SmokeFailure(f"GPClassifier: site change {float(delta)}, accuracy {accuracy}")
    checks.append({"path": "GPClassifier.fit", "against": "convergence and training accuracy",
                   "n": shapes["gpc"], "site_delta": float(delta), "accuracy": accuracy})
    got, want = small["GPClassifier.fit"], cpu["GPClassifier.fit"]
    check("GPClassifier.fit", "port on cpu", ZOO_TOL["cpu"],
          [("latent_mean", got[0], want[0]), ("predict_proba", got[2], want[2])],
          n=refs["gpc_cpu"])
    n_ss = shapes["gpssm"][0]
    t_ss, y_ss = data["gpssm_t_long"][:n_ss], data["gpssm_y_long"][:n_ss]
    for kern in ("matern32", "matern52"):
        name = f"GPSSM {kern}"
        got = outs[name]
        params = dict(lengthscale=2.0, variance=1.0, noise=0.1)
        t_dev = torch.from_numpy(t_ss[:, None]).to(device)
        exact = models.GP(kernel=kern, **params).fit(t_dev, torch.from_numpy(y_ss).to(device),
                                                     jitter=0.0)
        e_mean, e_var = exact.predict(t_dev)
        check(name, "port's exact GP", ZOO_TOL["gp_mean"], [("mean", got.mean, e_mean)], T=n_ss)
        check(name, "port's exact GP", ZOO_TOL["gpssm_var"], [("variance", got.variance, e_var)],
              T=n_ss)
        at = slice(None, None, refs["gpssm_stride"])
        mean, var, lml = numpy_gp(t_ss[:, None], y_ss, t_ss[at, None], kern, jitter=0.0,
                                  **params)
        check(name, "float64 numpy GP", ZOO_TOL["gp_mean"], [("mean", got.mean[at], mean)],
              T=n_ss, stride=refs["gpssm_stride"])
        check(name, "float64 numpy GP", ZOO_TOL["gpssm_var"],
              [("variance", got.variance[at], var)], T=n_ss, stride=refs["gpssm_stride"])
        check(name, "float64 numpy GP", ZOO_TOL["evidence"],
              [("lml", got.log_marginal_likelihood, lml)], T=n_ss)

    stage("references: GPs")

    # PPCA and FA.
    *_, q, _ = shapes["ppca"]
    Y64 = data["ppca"].astype(np.float64)
    Yc = Y64 - Y64.mean(0)
    evals, evecs = np.linalg.eigh(Yc.T @ Yc / len(Yc))
    d_p = Y64.shape[1]
    sigma2 = evals[: d_p - q].mean()
    W = evecs[:, -q:] * np.sqrt(np.maximum(evals[-q:] - sigma2, 0.0))
    got = outs["ppca_closed_form"]
    check("ppca_closed_form", "float64 numpy eigh", ZOO_TOL["ppca_wwt"],
          [("W Wᵀ", got.W @ got.W.T, W @ W.T)])
    check("ppca_closed_form", "float64 numpy eigh", ZOO_TOL["ppca_sigma2"],
          [("sigma2", got.sigma2, sigma2)])
    C_full = W @ W.T + sigma2 * np.eye(d_p)
    ll = -0.5 * len(Yc) * (d_p * math.log(2.0 * math.pi) + np.linalg.slogdet(C_full)[1]
                           + np.trace(np.linalg.solve(C_full, Yc.T @ Yc / len(Yc))))
    check("ppca_closed_form", "float64 numpy eigh", ZOO_TOL["ppca_ll"],
          [("log_likelihood", got.log_likelihood, ll)])
    em = outs["PPCA.fit_em"]

    def projector(W):
        Qm, _ = np.linalg.qr(_host64(W))
        return Qm @ Qm.T

    check("PPCA.fit_em", "closed form's subspace", (ZOO_TOL["projector"], 0.0),
          [("projector", projector(em.W), projector(got.W))])
    for name in ("PPCA.fit_em", "FactorAnalysis.fit_em"):
        lls = _host64(outs[name].log_likelihood)
        drop = float(np.min(np.diff(lls) / np.abs(lls[1:])))
        if not (np.isfinite(lls).all() and drop > -ZOO_TOL["monotone"]):
            raise SmokeFailure(f"{name}: the log-likelihood trace fell by {drop} of its size")
        checks.append({"path": name, "against": "a non-decreasing trace", "iterations": len(lls),
                       "bar": ZOO_TOL["monotone"], "largest_relative_drop": drop})
    got, want = small["FactorAnalysis.fit_em"], cpu["FactorAnalysis.fit_em"]
    check("FactorAnalysis.fit_em", "port on cpu", ZOO_TOL["cpu"],
          [("W Wᵀ", got.W @ got.W.T, want.W @ want.W.T), ("psi", got.psi, want.psi),
           ("log_likelihood", got.log_likelihood, want.log_likelihood)], n=n_cpu)

    stage("references: PPCA, FA")

    # BOCPD.
    n_b, n_bc = refs["bocpd"], refs["bocpd_cpu"]
    for name, key, model in (("BOCPD GaussianNIG", "bocpd_gauss", "gaussian"),
                             ("BOCPD BernoulliBeta", "bocpd_bern", "bernoulli")):
        got = outs[name]
        logp, cp, log_z = numpy_bocpd(data[key][:n_b], model, r_max=shapes["bocpd"][2])
        mass = logp > -25.0
        check(name, "float64 numpy BOCPD", ZOO_TOL["bocpd"],
              [("run_length_logprobs", got.run_length_logprobs[:n_b][torch.from_numpy(mass)],
                logp[mass]), ("changepoint_prob", got.changepoint_prob[:n_b], cp)],
              replicas=n_b)
        check(name, "float64 numpy BOCPD", ZOO_TOL["bocpd_evidence"],
              [("log_evidence", got.log_evidence[:n_b], log_z)], replicas=n_b)
        want = cpu[name]
        check(name, "port on cpu", ZOO_TOL["cpu"],
              [("changepoint_prob", got.changepoint_prob[:n_bc], want.changepoint_prob),
               ("log_evidence", got.log_evidence[:n_bc], want.log_evidence)], replicas=n_bc)
    stage("references: BOCPD")
    return checks


def phase_zoo_main_path(torch, models, ops, kernels, card: str) -> dict:
    """The rest of the zoo at ZOO_SHAPES on the card: the checks, K1-K4's
    counts over them (all 0), then each call's time (CUDA events, the median
    of 3 calls, 1 past ZOO_SLOW_MS, the checked call's past ZOO_KEEP_MS),
    device time, kernels and the host's share from one profiled call; the
    GPSSM at the longer T is timed once, unprofiled (some 550,000 kernels).
    Returns {"launches", "times"}."""
    start = time.perf_counter()
    _kernel_launches_zero(kernels)
    data = zoo_data(ZOO_SHAPES)
    first, stages = {}, {}
    checks = run_zoo_main_path(torch, models, ops, "cuda", data=data, times=first, stages=stages)
    launches = _check_no_kernel_launched(kernels, "zoo_main_path")
    for check in checks:
        emit(phase="zoo_main_path", **check)
    emit(phase="zoo_main_path", seconds=time.perf_counter() - start, stages=stages)
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    result = {}
    for name, fn in zoo_calls(torch, models, ops, "cuda", data).items():
        if (name.startswith(("NonlinearSSM.log_evidence", "linear "))
                or name == "GPSSM matern52 long"):
            continue  # the filter's call, the linear check's; one long GPSSM is enough
        if name.endswith(" long"):
            ms = median_ms(torch, fn, flush, runs=1, warmup=0)
            result[name] = ms
            emit(phase="zoo_times", path=name, T=ZOO_SHAPES["gpssm"][1], ms=ms,
                 device_ms="not measured", card=card)
            continue
        slow = first[name] > ZOO_SLOW_MS
        if first[name] > ZOO_KEEP_MS:
            ms = first[name]
        else:
            ms = median_ms(torch, fn, flush, runs=1 if slow else 3, warmup=0)
        result[name] = ms
        count = _profile_once(torch, fn)
        if not count["kernels"]:  # a profile now and then holds no kernel record
            count = _profile_once(torch, fn)
        emit(phase="zoo_times", path=name, ms=ms, runs=1 if slow else 3,
             from_checked_run=first[name] > ZOO_KEEP_MS,
             device_ms=count["device_ms"], host_share=1.0 - count["device_ms"] / ms,
             kernels_per_call=count["kernels"], copies_per_call=count["copies"],
             top_kernels=count["top"], card=card)
    emit(phase="zoo_times", seconds=time.perf_counter() - start)
    return {"launches": launches, "times": result}


# Phases 22-23: serving, checkpointing, diagnostics and the native signal core.
# The servers: LGSSM through K1 (paths_10k's model, T=100) on every bucket
# from 8 to 16,384 replicas, compiled up front; the HMM through K3
# (HMM.smooth(method="fused")) and K2 at ladder.hmm (T=64, K=4, M=8) on buckets
# 8 to 4,096, compiled as requests reach them.  Export: K1's server function at
# 10,000 x 100.  Checkpoint/resume: the HGF stream at ladder.hgf.  Diag: GMM.fit
# at ladder.gmm; R-hat and ESS of AR(1) draws, phi = 0.5, 64 chains x 2,000.
SERVE_SHAPES = {
    "lgssm": {"T": T_MAIN, "max_batch": 16_384, "min_bucket": 8,
              "requests": (3, 1_000, 4_097, 10_000, 16_384), "precompile": True},
    "hmm": {"T": HMM_T, "K": HMM_K, "M": HMM_M, "max_batch": 4_096, "min_bucket": 8,
            "requests": (5, 700, 4_096)},
    "export": (R_MAIN, T_MAIN),
    "hgf": (HGF_R, HGF_T, HGF_CHUNK),
    "gmm": (GMM_R, GMM_N),
    "ar1": (64, 2_000, 0.5),
    "fanout": 300,  # tests/test_native.py::test_native_perf_smoke's dense network
}
# Checkpoint after this many chunks of the HGF stream, kept by a manager of 2.
SERVE_SAVE_AFTER, SERVE_KEEP = 4, 2
# R-hat and ESS on the card (float64) against float64 numpy: rtol 1e-5, the
# port's bar against JAX (tests/test_torch_diag.py); ESS of AR(1) within 0.5x
# to 2x of M N (1 - phi) / (1 + phi), the bar of tests/test_diag_tracing.py.
DIAG_RTOL, ESS_BAND = 1e-5, (0.5, 2.0)
SERVE_PROCESS_TIMEOUT = 300  # seconds a fresh process of phase 22 may take


def numpy_rhat(chains):
    """Float64 split-R-hat over (M, N) draws, the formulas of diag.rhat."""
    x = np.asarray(chains, dtype=np.float64)
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]], axis=0)
    w = x.var(axis=1, ddof=1).mean(axis=0)
    b = half * x.mean(axis=1).var(axis=0, ddof=1)
    return np.sqrt((w * (half - 1) / half + b / half) / w)


def numpy_ess(chains, max_lag: int = 200):
    """Float64 ESS over (M, N) draws: the autocovariance summed lag by lag
    (not by FFT), Geyer's pairs truncated at the first negative one."""
    x = np.asarray(chains, dtype=np.float64)
    m, n = x.shape
    max_lag = min(max_lag, n - 1)
    xc = x - x.mean(axis=1, keepdims=True)
    acov = np.stack([(xc[:, : n - k] * xc[:, k:]).sum(axis=1) / n
                     for k in range(max_lag + 1)], axis=1)
    rhos = (acov[:, 1:] / np.maximum(acov[:, :1], 1e-30)).mean(axis=0)
    n_pairs = max_lag // 2
    pair = rhos[: 2 * n_pairs].reshape(n_pairs, 2).sum(axis=1)
    keep = np.cumprod(pair > 0)
    return m * n / max(1.0 + 2.0 * float((pair * keep).sum()), 1.0)


def _fresh_process(script: str, workdir: Path) -> dict:
    """Run ``script`` in a fresh Python process from the repository's root and
    return the JSON object of its last line of output; raises SmokeFailure
    with its log if it fails or outlives SERVE_PROCESS_TIMEOUT."""
    log = workdir / "fresh.log"
    with open(log, "w") as out:
        try:
            proc = subprocess.run([sys.executable, "-c", script], stdout=out,
                                  stderr=subprocess.STDOUT, cwd=REPO,
                                  timeout=SERVE_PROCESS_TIMEOUT)
        except subprocess.TimeoutExpired as e:
            raise SmokeFailure(f"a fresh process outlived {e.timeout} s:\n"
                               f"{log.read_text()[-4000:]}") from e
    text = log.read_text()
    if proc.returncode != 0:
        raise SmokeFailure(f"a fresh process exited with {proc.returncode}:\n{text[-4000:]}")
    return json.loads(text.strip().splitlines()[-1])


# A fresh process that imports the kernels' operators and nothing of the
# models, loads a saved program and runs it on saved inputs.
LOAD_PROGRAM = """
import json, sys, time
sys.path.insert(0, {repo!r})
import torch
import cortex_tpu_torch.ops  # registers the kernels' operators
start = time.perf_counter()
y = torch.load({inputs!r}).to({device!r})  # on the card, this starts CUDA
inputs = time.perf_counter() - start
start = time.perf_counter()
module = torch.export.load({blob!r}).module()
loaded = time.perf_counter() - start
out = module(y)
torch.save([o.cpu() for o in out], {outputs!r})
print(json.dumps({{"inputs_s": inputs, "load_s": loaded, "modules": sorted(
    m for m in sys.modules if m.startswith("cortex_tpu_torch"))}}))
"""

# A fresh process that points the build directory at a cache, then builds or
# loads the kernels (on the card) and the native signal core from there.
USE_CACHE = """
import json, sys, time
sys.path.insert(0, {repo!r})
from cortex_tpu_torch import _build, serve
from cortex_tpu_torch.native import bindings
serve.enable_persistent_cache({cache!r})
report = {{}}
libraries = {{"native": (bindings.library_path, bindings.load_native_lib)}}
if {device!r} == "cuda":
    from cortex_tpu_torch.ops import kernels
    libraries["kernels"] = (_build.library_path, kernels._library)
for name, (where, load) in libraries.items():
    path = where()
    existed = path.exists()
    start = time.perf_counter()
    load()
    report[name] = {{"seconds": time.perf_counter() - start, "found": existed,
                    "path": str(path), "in_cache": path.parent == _build.BUILD_DIR}}
print(json.dumps(report))
"""


def _exact(name: str, got, want) -> float:
    """Require ``got`` to equal ``want`` (same shape, every value); return the
    largest absolute difference, 0."""
    err = check_close(name, got, want, 0.0, 0.0)
    if err != 0.0:
        raise SmokeFailure(f"{name}: differs by {err}")
    return err


def serve_servers(torch, models, ops, serve, device, shapes=SERVE_SHAPES, seed: int = 50):
    """The servers of the serving phase, on ``device``: ``{name: (server,
    eager fn, kernel, requests)}`` with the requests' inputs (float32 on
    ``device``), and the HMM's numpy inputs for the float64 references."""
    lg = shapes["lgssm"]
    servers = {}
    smooth = lambda y: ops.lgssm_smooth_fused(y)  # noqa: E731
    servers["lgssm"] = (
        serve.BucketedServer(smooth, (torch.zeros((8, lg["T"]), device=device),),
                             max_batch=lg["max_batch"], min_bucket=lg["min_bucket"],
                             precompile=lg["precompile"]),
        smooth, "lgssm_smooth",
        [torch.from_numpy(random_walk(n, lg["T"], seed=seed + n)).to(device)
         for n in lg["requests"]])
    hm = shapes["hmm"]
    K, M = hm["K"], hm["M"]
    rng = np.random.default_rng(seed)
    A = rng.random((K, K)) + 0.2
    A /= A.sum(axis=1, keepdims=True)
    B = rng.random((K, M)) + 0.2
    B /= B.sum(axis=1, keepdims=True)
    log_A = torch.from_numpy(np.log(A).astype(np.float32)).to(device)
    model = models.HMM(K, torch.log(torch.full((K,), 1.0 / K))).to(device)
    lls = []
    for n in hm["requests"]:
        obs = np.abs(rng.normal(size=(n, hm["T"])).cumsum(axis=-1)).astype(np.int64) % M
        lls.append(np.log(B).T[obs].astype(np.float32))  # (n, T, K)
    hmm_smooth = lambda ll: model.smooth(ll, log_A, method="fused")  # noqa: E731
    fb = lambda lik: ops.hmm_forward_backward_fused(  # noqa: E731
        lik, torch.exp(log_A), torch.exp(model.log_pi))
    example = torch.zeros((8, hm["T"], K), device=device)
    for name, fn, kernel, inputs in (
        ("hmm smooth", hmm_smooth, "hmm_fb_counts",
         [torch.from_numpy(ll).to(device) for ll in lls]),
        ("hmm fb", fb, "hmm_fb", [torch.from_numpy(np.exp(ll)).to(device) for ll in lls]),
    ):
        servers[name] = (serve.BucketedServer(fn, (example,), max_batch=hm["max_batch"],
                                              min_bucket=hm["min_bucket"]), fn, kernel, inputs)
    refs = {"log_A": np.log(A), "log_pi": np.log(np.full(K, 1.0 / K)), "lls": lls}
    return servers, refs


def run_servers(torch, models, ops, serve, device, shapes=SERVE_SHAPES,
                n_ref: int = N_RTS) -> dict:
    """Drive the servers of :func:`serve_servers` once on ``device`` and check
    them: each request's answer equal to the eager call on the unpadded
    request and within the float64 bars (the RTS at 2e-4; the
    forward-backward at the HMM main path's gamma 1e-4 and log-evidence rtol
    1e-4) on the first ``n_ref`` replicas; on the card one launch of the
    kernel captured into every bucket's graph (its name in a profiled replay
    is :func:`run_replay_profile`'s).  Returns ``{"checks", "captured",
    "servers"}``."""
    servers, refs = serve_servers(torch, models, ops, serve, device, shapes)
    checks, captured = [], {}
    for name, (server, eager, kernel, inputs) in servers.items():
        for i, x in enumerate(inputs):
            n = x.shape[0]
            got, want = server(x), eager(x)
            diffs = {field: _exact(f"{name} {n} {field}", g, w)
                     for field, g, w in zip(got._fields, got, want)}
            rows = min(n, n_ref)
            if name == "lgssm":
                sm, sv = numpy_rts(x[:rows].cpu().numpy())
                ref = {"mean": check_close(f"{name} {n} mean", got.mean[:rows], sm, 2e-4),
                       "variance": check_close(f"{name} {n} variance", got.variance[:rows],
                                               sv, 2e-4)}
            else:
                gamma_ref, log_z = numpy_hmm_smoother(refs["lls"][i][:rows], refs["log_A"],
                                                      refs["log_pi"])
                gamma = (torch.exp(got.log_gamma) if name == "hmm smooth" else got.gamma)[:rows]
                ref = {"gamma": check_close(f"{name} {n} gamma", gamma, gamma_ref, 1e-4, 0.0),
                       "log_evidence": check_close(f"{name} {n} log_evidence",
                                                   got.log_evidence[:rows], log_z, 0.0, 1e-4)}
            checks.append({"server": name, "request": n, "bucket": serve._bucket_for(
                n, server.buckets), "max_abs_diff_vs_eager": diffs,
                "max_abs_err_vs_float64": ref, "replicas_vs_float64": rows})
        captured[name] = {b: server.compiled(b).captured_launches.get(kernel, 0)
                          for b in server.compiled_buckets}
        if device != "cpu":
            wrong = {b: c for b, c in captured[name].items() if c != 1}
            if wrong:
                raise SmokeFailure(f"{name}: {kernel} captured {wrong} times, not once a bucket")
            checks.append({"server": name, "kernel": kernel, "captured_per_bucket": captured[name]})
    return {"checks": checks, "captured": captured, "servers": servers}


# A fresh process that captures each server's top bucket as serve_servers
# builds it and names the device kernels of one profiled replay.  In the
# process that ran the earlier phases, whose profiles hold tens of thousands of
# kernels, torch.profiler has come back with no device record at all, three
# profiles running; a fresh process's first profile (after one to wake CUPTI)
# records them.
PROFILE_REPLAY = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
import chip_smoke as smoke
from cortex_tpu_torch import models, ops, serve
shapes = dict(smoke.SERVE_SHAPES, lgssm=dict(smoke.SERVE_SHAPES["lgssm"], precompile=False))
servers, _ = smoke.serve_servers(torch, models, ops, serve, "cuda", shapes)
smoke._profile_once(torch, lambda: torch.ones(1, device="cuda").add_(1))
report = {{}}
for name, (server, _, kernel, inputs) in servers.items():
    b = server.buckets[-1]
    x = server._pad((inputs[-1],), b)[0]
    compiled = server.compiled(b)
    compiled(x)
    for attempt in range(3):  # a profile now and then holds no kernel record
        names = [n for n, _, _ in smoke._profile_once(torch, lambda: compiled(x))["top"]]
        if names:
            break
    report[name] = {{"kernel": kernel, "bucket": b, "profiles": attempt + 1, "names": names,
                    "captured": compiled.captured_launches.get(kernel, 0)}}
print(json.dumps(report))
"""


def run_replay_profile(workdir) -> list:
    """Each server's top bucket captured and replayed once under
    torch.profiler in a fresh process (PROFILE_REPLAY): the replay must run
    the server's kernel, by name.  Returns the checks."""
    report = _fresh_process(PROFILE_REPLAY.format(repo=REPO), Path(workdir))
    checks = []
    for name, run in report.items():
        wanted = DEVICE_KERNELS["kernel" if run["kernel"] == "lgssm_smooth" else run["kernel"]]
        # A replay runs a copy in, the graph's kernels and the clones: the
        # five longest name them all.
        ran = sorted(n[:60] for n in run["names"] if any(w in n for w in wanted))
        if run["captured"] != 1 or not ran:
            raise SmokeFailure(f"{name}: a replay of bucket {run['bucket']} ran no {wanted} "
                               f"(captured {run['captured']}): {run['names']}")
        checks.append({"server": name, "kernel": run["kernel"], "replay_bucket": run["bucket"],
                       "replay_ran": ran, "profiles": run["profiles"],
                       "profiled_in": "a fresh process"})
    return checks


def run_export(torch, ops, serve, device, workdir, shape=SERVE_SHAPES["export"]) -> dict:
    """Export K1's server function (a plain tuple out) at ``shape`` on
    ``device``: one kernel node; loaded in a fresh process that imports only
    ``cortex_tpu_torch.ops``, its answer equals the eager call.  Returns the
    check."""
    import io

    workdir = Path(workdir)
    R, T = shape
    y = torch.from_numpy(random_walk(R, T, seed=R)).to(device)
    fn = lambda y: tuple(ops.lgssm_smooth_fused(y))  # noqa: E731
    start = time.perf_counter()
    blob = serve.export_serialized(fn, y)
    export_s = time.perf_counter() - start
    program = torch.export.load(io.BytesIO(blob))
    nodes = [n for n in program.graph.nodes if n.op == "call_function"
             and getattr(n.target, "namespace", None) == ops.kernels.NAMESPACE]
    if len(nodes) != 1:
        raise SmokeFailure(f"the exported K1 function holds {len(nodes)} kernel nodes, not 1")
    (workdir / "k1.pt2").write_bytes(blob)
    torch.save(y.cpu(), workdir / "y.pt")
    loaded = _fresh_process(LOAD_PROGRAM.format(
        repo=REPO, blob=str(workdir / "k1.pt2"), inputs=str(workdir / "y.pt"), device=device,
        outputs=str(workdir / "out.pt")), workdir)
    if any(m.startswith(("cortex_tpu_torch.models", "cortex_tpu_torch.serve"))
           for m in loaded["modules"]):
        raise SmokeFailure(f"loading the program imported model code: {loaded['modules']}")
    mean, var = torch.load(workdir / "out.pt")
    eager = ops.lgssm_smooth_fused(y)
    return {"export": [R, T], "blob_bytes": len(blob), "kernel_nodes": len(nodes),
            "export_s": export_s, "fresh_inputs_s": loaded["inputs_s"],
            "fresh_load_s": loaded["load_s"],
            "fresh_modules": len(loaded["modules"]),
            "max_abs_diff_vs_eager": {"mean": _exact("loaded mean", mean, eager.mean),
                                      "variance": _exact("loaded variance", var,
                                                         eager.variance)}}


def run_persistent_cache(device, workdir) -> dict:
    """Two fresh processes share one ``enable_persistent_cache`` directory
    under ``workdir``: the first builds the native signal core (and on the
    card the kernels) there, the second finds and loads them.  Returns the
    check with both processes' seconds."""
    workdir = Path(workdir)
    cache = workdir / "cache"
    runs = [_fresh_process(USE_CACHE.format(repo=REPO, cache=str(cache), device=device), workdir)
            for _ in range(2)]
    for lib in runs[0]:
        if runs[0][lib]["found"] or not runs[1][lib]["found"] or not runs[1][lib]["in_cache"]:
            raise SmokeFailure(f"the cache did not carry {lib} to the second process: {runs}")
    return {"persistent_cache": {lib: {"first_s": runs[0][lib]["seconds"],
                                       "second_s": runs[1][lib]["seconds"],
                                       "second_found_it_built": runs[1][lib]["found"]}
                                 for lib in runs[0]}}


def run_resume_and_diag(torch, models, device, workdir, shapes=SERVE_SHAPES, seed: int = 60,
                        n_ref: int = N_GMM) -> list:
    """Checkpoint/resume and diagnostics on ``device``: the HGF streamed by
    chunks, checkpointed by a manager of SERVE_KEEP after each of the first
    SERVE_SAVE_AFTER chunks, restored into a fresh state and run to the end,
    whose finals must equal the uninterrupted stream's bit for bit; GMM.fit's
    free energies through ConvergenceMonitor (no replica diverges) and
    check_finite on its result; rhat and ess of AR(1) draws made on
    ``device`` against float64 numpy (DIAG_RTOL) and ESS against its value
    for AR(1) (ESS_BAND).  Returns the checks."""
    from cortex_tpu_torch import checkpoint, diag

    checks = []
    R, T, chunk = shapes["hgf"]
    model = models.HGF()
    u = torch.from_numpy(hgf_data(R, T, "walk", seed)).to(device)
    pieces = u.split(chunk, dim=1)

    def stream(state, parts):
        for part in parts:
            state, _ = model.filter(part, state=state, tracks=())
        return state

    whole = stream(model.init_state((R,), device=device), pieces)
    manager = checkpoint.CheckpointManager(str(Path(workdir) / "ckpt"), max_to_keep=SERVE_KEEP)
    state = model.init_state((R,), device=device)
    save_ms = []
    for k in range(SERVE_SAVE_AFTER):
        state = stream(state, pieces[k:k + 1])
        start = time.perf_counter()
        path = manager.save(k + 1, state)
        save_ms.append((time.perf_counter() - start) * 1e3)
    kept = sorted(os.listdir(manager.directory))
    want_kept = [f"ckpt_{k}.npz" for k in range(SERVE_SAVE_AFTER - SERVE_KEEP + 1,
                                                SERVE_SAVE_AFTER + 1)]
    if kept != want_kept:
        raise SmokeFailure(f"the manager kept {kept}, not {want_kept}")
    start = time.perf_counter()
    restored = manager.restore(model.init_state((R,), device=device))
    restore_ms = (time.perf_counter() - start) * 1e3
    if type(restored) is not type(whole):
        raise SmokeFailure(f"restored a {type(restored).__name__}, not a {type(whole).__name__}")
    resumed = stream(restored, pieces[SERVE_SAVE_AFTER:])
    diffs = {field: _exact(f"resumed {field}", g, w)
             for field, g, w in zip(whole._fields, resumed, whole)}
    checks.append({"path": "HGF stream resumed from a checkpoint", "R": R, "T": T,
                   "chunks": len(pieces), "saved_after": SERVE_SAVE_AFTER, "kept": kept,
                   "file_bytes": os.path.getsize(path), "save_ms": save_ms,
                   "restore_ms": restore_ms, "max_abs_diff_vs_uninterrupted": diffs})

    R, N = shapes["gmm"]
    x = torch.from_numpy(gmm_data(R, N, GMM_D, GMM_K, seed)).to(device)
    fit = models.GMM(K=GMM_K).fit(x, n_iterations=GMM_ITERS, init_means=x[:, :GMM_K])
    monitor = diag.ConvergenceMonitor(rtol=GMM_MONOTONE_RTOL)
    for it in range(fit.free_energy.shape[-1]):
        monitor.update(fit.free_energy[..., it])
    monitor.raise_if_diverged("GMM.fit")
    diag.check_finite(fit, where="GMM.fit")
    checks.append({"path": "ConvergenceMonitor over GMM.fit", "R": R, "N": N,
                   "iterations": len(monitor.history), "diverged": int(monitor.diverged.sum()),
                   "check_finite": "passed"})

    m, n, phi = shapes["ar1"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    eps = torch.randn((n, m), generator=gen, device=device, dtype=torch.float64)
    z = torch.empty_like(eps)
    z[0] = eps[0]
    for t in range(1, n):
        z[t] = phi * z[t - 1] + eps[t]
    draws = z.t().contiguous()
    got_rhat, got_ess = float(diag.rhat(draws)), float(diag.ess(draws))
    host = draws.cpu().numpy()
    want_rhat, want_ess = float(numpy_rhat(host)), float(numpy_ess(host))
    expected = m * n * (1 - phi) / (1 + phi)
    for name, got, want in (("rhat", got_rhat, want_rhat), ("ess", got_ess, want_ess)):
        if not abs(got - want) <= DIAG_RTOL * abs(want):
            raise SmokeFailure(f"{name}: {got} against float64 numpy's {want}")
    if not ESS_BAND[0] * expected < got_ess < ESS_BAND[1] * expected:
        raise SmokeFailure(f"ess {got_ess} outside {ESS_BAND} x {expected}")
    checks.append({"path": "rhat, ess of AR(1)", "chains": m, "draws": n, "phi": phi,
                   "rhat": got_rhat, "ess": got_ess, "ess_expected": expected,
                   "rel_err_rhat": abs(got_rhat - want_rhat) / abs(want_rhat),
                   "rel_err_ess": abs(got_ess - want_ess) / abs(want_ess), "rtol": DIAG_RTOL})
    return checks


def native_fanout(n: int = SERVE_SHAPES["fanout"]) -> dict:
    """Seconds of one fan-out on a dense network of n sources and n sinks
    (every sink on every source), native and Python signal cores:
    tests/test_native.py::test_native_perf_smoke's network."""
    from cortex_tpu_torch.core import Signal
    from cortex_tpu_torch.native import NativeSignalEngine

    def build(create):
        sources = [create() for _ in range(n)]
        sinks = [create() for _ in range(n)]
        for snk in sinks:
            for src in sources:
                snk.add_dependency(src)
        return sources, sinks

    def drive(sources, sinks):
        start = time.perf_counter()
        for s in sources:
            s.set_value(1)
        hits = sum(1 for s in sinks if s.is_pending())
        return time.perf_counter() - start, hits

    engine = NativeSignalEngine()
    t_native, hits_native = drive(*build(engine.create_signal))
    t_python, hits_python = drive(*build(Signal))
    if not hits_native == hits_python == n:
        raise SmokeFailure(f"fan-out reached {hits_native} / {hits_python} sinks, not {n}")
    return {"native_s": t_native, "python_s": t_python, "sinks": n}


def phase_serve_main_path(torch, models, ops, kernels, card: str) -> dict:
    """Phase 22: the serving path, checkpoint/resume and diagnostics on the
    card; K1-K4's launches over the serving run; returns {"launches",
    "captured", "servers"}."""
    from cortex_tpu_torch import serve

    start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="serve_") as workdir:
        _kernel_launches_zero(kernels)
        run = run_servers(torch, models, ops, serve, "cuda")
        launches = dict(kernels.LAUNCHES)
        for check in (run["checks"] + run_replay_profile(workdir)
                      + [run_export(torch, ops, serve, "cuda", workdir),
                         run_persistent_cache("cuda", workdir)]):
            emit(phase="serve_main_path", **check)
        emit(phase="serve_main_path", launches=launches,
             note="each graph counts its kernel once, at capture; warm-ups and the eager "
                  "comparisons count too")
        for check in run_resume_and_diag(torch, models, "cuda", workdir):
            emit(phase="serve_main_path", **check)
    emit(phase="serve_main_path", seconds=time.perf_counter() - start, card=card)
    return {"launches": launches, "captured": run["captured"], "servers": run["servers"]}


def replay_parts_us(torch, compiled, x, runs: int = 100) -> dict:
    """Host µs (median of ``runs``, each after a synchronize) of a compiled
    call on ``x`` and of its parts: the argument check, the copy into the
    graph's input buffer, the replay's launch and the copies of the
    outputs."""
    from cortex_tpu_torch.utils.tree import tree_map

    parts = {"call": lambda: compiled(x), "check": lambda: compiled._check((x,)),
             "copy_in": lambda: compiled._inputs[0].copy_(x),
             "replay": compiled._graph.replay,
             "copy_out": lambda: tree_map(torch.clone, compiled._outputs)}
    result = {}
    for name, fn in parts.items():
        for _ in range(10):
            fn()
        times = []
        for _ in range(runs):
            torch.cuda.synchronize()
            start = time.perf_counter()
            fn()
            times.append((time.perf_counter() - start) * 1e6)
        result[name] = statistics.median(times)
    torch.cuda.synchronize()
    return result


def phase_serve_times(torch, servers: dict, card: str) -> dict:
    """Phase 23: each compiled bucket's call (copy in, replay, copy out)
    against the eager call at the same size (CUDA events, the median of 25
    calls after a read that evicts L2), each with its device time (the same
    events with the call queued behind a sleep on the card: queued_ms) and
    the host's share; for K1's buckets, the host time of a replayed call's
    parts (replay_parts_us); the native and Python signal cores' fan-out on
    the host.
    Returns {server: {bucket: {...}}}."""
    start = time.perf_counter()
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    result = {}
    for name, (server, eager, _, inputs) in servers.items():
        result[name] = {}
        for b in server.compiled_buckets:
            x = server._pad((inputs[-1],), b)[0]
            compiled = server.compiled(b)
            row = {}
            for path, fn in (("replay", lambda: compiled(x)), ("eager", lambda: eager(x))):
                ms = median_ms(torch, fn, flush)
                device = queued_ms(torch, fn, flush)
                row[path] = {"ms": ms, "device_ms": device, "host_share": 1.0 - device / ms}
            if name == "lgssm":
                row["replay_host_us"] = replay_parts_us(torch, compiled, x)
            result[name][b] = row
            emit(phase="serve_times", server=name, bucket=b, **row,
                 eager_over_replay=row["eager"]["ms"] / row["replay"]["ms"], card=card)
    fanout = native_fanout()
    if not fanout["native_s"] < fanout["python_s"]:
        raise SmokeFailure(f"the native fan-out was not faster than Python's: {fanout}")
    emit(phase="serve_times", path="signal fan-out on the host", **fanout,
         python_over_native=fanout["python_s"] / fanout["native_s"])
    emit(phase="serve_times", seconds=time.perf_counter() - start, card=card)
    return result


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
    phase_zoo_main_path(torch, models, ops, kernels, device["nvidia_smi"])
    serving = phase_serve_main_path(torch, models, ops, kernels, device["nvidia_smi"])
    phase_serve_times(torch, serving["servers"], device["nvidia_smi"])
    # Each kernel's launches over every run of a main path that launches it;
    # on the serving path, those captured into its graphs (one a bucket, each
    # replayed per request).
    captured = {kernel: sum(serving["captured"][name].values())
                for name, (_, _, kernel, _) in serving["servers"].items()}
    by_phase = {name: {"main path": count, **{
        f"parallel_main_path {world}": run["launches"][name] for world, run in worlds.items()},
        "serve_main_path, captured into its graphs": captured.get(name, 0)}
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
