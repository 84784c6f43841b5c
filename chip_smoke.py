"""Drive the PyTorch port's LGSSM smoothing, HMM and HGF paths once on an NVIDIA GPU.

Run from the root of a checkout, with one CUDA card::

    python3 chip_smoke.py

It imports nothing of JAX: its references are a float64 numpy RTS smoother,
a float64 numpy log-space forward-backward, a float64 numpy HGF and the
port's own plain versions.  Phases, each printing JSON lines:

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
import time

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


def numpy_rts(y, A=1.0, Q=1.0, H=1.0, R=1.0):
    """Float64 Kalman filter + RTS smoother over the rows of ``y`` (n, T),
    with no prior on the first state: returns ``(mean, variance)``, (n, T)."""
    y = np.asarray(y, dtype=np.float64)
    n, T = y.shape
    fm = np.empty((n, T))
    fv = np.empty(T)  # the variances do not depend on the data
    fm[:, 0], fv[0] = y[:, 0] / H, R / (H * H)
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


def _count_kernels(torch, fn) -> dict:
    """The device kernels (and copies) that one call of ``fn`` launches, and
    their device time, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    device_us = 0.0
    for avg in prof.key_averages():
        us = getattr(avg, "self_device_time_total", 0.0) or getattr(
            avg, "self_cuda_time_total", 0.0)
        if us <= 0:
            continue
        device_us += us
        if avg.key.startswith(("Memcpy", "Memset")):
            copies += avg.count
        else:
            kernels += avg.count
    return {"kernels": kernels, "copies": copies, "device_ms": device_us / 1e3}


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
    hmm_source = "cortex_tpu_torch/csrc/hmm_forward_backward.cu"
    print(json.dumps({"kernels": [
        {
            "name": "lgssm_smooth",
            "route": "cuda",
            "source": "cortex_tpu_torch/csrc/lgssm_smooth.cu",
            "replaces": "cortex_tpu/ops/pallas_kernels.py:99",
            "launches": launches["lgssm_smooth"],
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
            "launches": launches[name],
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
            "launches": launches["hgf_filter"],
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
