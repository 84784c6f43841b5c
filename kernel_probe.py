"""Time the port's kernels K1 (LGSSM sweep), K2/K3 (HMM forward-backward) and K4
(HGF filter) on one CUDA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc::

    python3 kernel_probe.py compare OTHER...  # this tree's kernels against others'
    python3 kernel_probe.py breakdown OTHER   # OTHER's kernels with parts cut out
    python3 kernel_probe.py ... --kernels hmm # only some: k1, hmm, k4, ts (breakdown: pair)

``OTHER`` is the root of another checkout of this repository, for example an
earlier commit unpacked with ``git archive`` into the git-ignored ``build/``.
Its ``cortex_tpu_torch`` package is copied to ``build/probe/`` under the name
``cortex_tpu_torch_other<i>`` and imported beside this tree's, so all run in
one process on one card.

``compare`` times K1 at 10,000 and 100,000 replicas x T=100, K2 and K3 at
4,096 and 65,536 replicas x T=64 x K=4, and K4 at 65,536 x 256 for three
track sets (none, all five float32, mu1+mu2 bf16), each kernel of every tree
in turns (others, this, then the reverse), by the device time that
``torch.profiler`` reports, and reports how far each tree's result lies from
the first's.  For this tree it also times K2 and K3 at K=4, 8 and 16 on each
of its small-K paths (the pair path, a lane group a replica), forced through
``kernels_hmm.PAIR_K_MAX``.  ``ts`` times the time-sharded smoother's three
passes (``ops/kernels_time_sharded.py``, a hand-written kernel with no Pallas
counterpart) on one rank's block of the ``lgssm.timeshard-4chip`` cell,
10,000 x 16,384 (the whole chain on one rank: prior-free first step, terminal
last step), each pass alone, and their plain version (``LocalSweep``'s plain
passes, in float32) on the same block; it reports each pass's register report
and how far the passes' marginals lie from the plain version's.  A tree
without the passes is skipped.

``breakdown`` builds variants of OTHER's kernel sources with one part cut
out each, written as scratch sources under ``build/probe/`` (git-ignored) and
deleted after the build, and times them in turns the same way:
- K1: the sweep removed (load and store left), and the load removed too;
- K2/K3 (``hmm``): lik made in registers instead of loaded, the gamma stores
  skipped, the counts' shuffles removed (K3), and every division made a
  multiply;
- K2/K3's pair path (``pair``): the launch alone, the chains removed, the
  combine removed, the load of lik removed, the stores of gamma removed;
- K4: u made in registers instead of loaded, the track stores skipped, and
  both with the barriers removed (the step's arithmetic alone).
The K1 and K4 variants are text edits of the kernels of commit c5860b3, the
``hmm`` variants of the HMM source of commit b63e4d5 (unchanged since commit
6ea9016), the ``pair`` variants of the HMM source that added the pair path;
on other sources an edit that does not apply raises.  It also keeps the
compiler's register report and the SASS of each base kernel (of the small-K
kernels at K=4 alone, for each variant).

Every line printed is one JSON object, and the card's name and power limit
(``nvidia-smi``) come first.  ``--out DIR`` (default ``build/probe/out``)
receives a copy of the lines as ``probe.jsonl``, and the reports.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import os
import shutil
import statistics
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "probe")
OUT = os.path.join(WORK, "out")
OTHER_NAME = "cortex_tpu_torch_other"

K1_SHAPES = ((10_000, 100), (100_000, 100))
K4_SHAPE = (65_536, 256)
TS_SHAPE = (10_000, 16_384)
# The passes' kernels and the bytes each moves a step-lane: y read (pass 1);
# y read, the filtered moments written (2); those read, the marginals written (3).
TS_PASSES = {"filter_total": ("filter_total_kernel", 4),
             "filter_fillin": ("filter_fillin_kernel", 12),
             "smoother_fillin": ("smoother_fillin_kernel", 16)}
HMM_SHAPES = ((4096, 64, 4), (65_536, 64, 4))
# K2/K3 at K=4, 8 and 16 on each small-K path: PAIR_K_MAX 0 forces the lane
# groups.  At K=16 the pair path's rows do not fit: it takes the lane groups.
HMM_PATH_SHAPES = ((4096, 64, 4), (65_536, 64, 4), (4096, 64, 8), (4096, 64, 16))
HMM_PATHS = {"lane group": {"PAIR_K_MAX": 0}, "pair": {"PAIR_K_MAX": 8}}
ALL5 = ("mu1", "pi1", "mu2", "pi2", "delta1")
K4_CONFIGS = {"filter only": ((), False), "all five f32": (ALL5, False),
              "mu1 mu2 bf16": (("mu1", "mu2"), True)}

# Variants of the kernels of commit c5860b3: (source file, [(old, new), ...]).
_K4_NO_U = [
    ("    for (int k = threadIdx.x; k < count; k += kTile) {\n      int i, j;\n"
     "      split(k, n, i, j);\n      s_u[i * PU + j] = u[(r0 + i) * T + t0 + j];\n    }\n",
     ""),
    ("const float x = s_u[r * PU + j];",
     "const float x = 1e-3f * static_cast<float>(t0 + j + r);"),
]
_K4_NO_STORES = [("out[(r0 + i) * T + t0 + j] = s_track[k8][i * PT + j];", "")]
_K4_NO_TRACKS = [("if (s_track[k]) put(s_track[k] + r * PT + j, values[k]);", "")]
_K4_NO_BARRIERS = [("__syncthreads();", "")]
# Variants of the HMM source of commit b63e4d5.
_HMM_NO_LIK = [
    ("float a = (k < K ? pi[k] : 0.f) * (live ? L[k] : 0.f);",
     "float a = (k < K ? pi[k] : 0.f) * (live ? 0.6f : 0.f);"),
    ("float lik_next = (live && T > 1) ? L[K + k] : 0.f;",
     "float lik_next = (live && T > 1) ? 0.5f + 1e-3f * k : 0.f;"),
    ("if (t + 1 < T) lik_next = live ? L[(t + 1) * K + k] : 0.f;",
     "if (t + 1 < T) lik_next = live ? 0.5f + 1e-3f * ((t + k) & 7) : 0.f;"),
    ("float lik_up = live ? L[(T - 1) * K + k] : 0.f;",
     "float lik_up = live ? 0.7f : 0.f;"),
    ("const float lik_t = live ? L[t * K + k] : 0.f;",
     "const float lik_t = live ? 0.5f + 1e-3f * ((t + k) & 7) : 0.f;"),
]
# The marginal is still computed (the store is predicated on it), never stored.
_HMM_NO_GAMMA = [("if (live) out[t * K + k] = g / gs;",
                  "if (live && g / gs == -1.f) out[t * K + k] = 0.f;")]
_HMM_NO_COUNT_SHUFFLES = [
    ("const float N = group_sum<G>(a_t * u) + kFloor;", "const float N = a_t * u + kFloor;"),
    ("S[j] = fmaf(__shfl_sync(kFull, q, j, G), w, S[j]);", "S[j] = fmaf(q, w, S[j]);"),
]
_HMM_NO_DIVISIONS = [("a = a / n;", "a = a * n;"), ("b = u / s;", "b = u * s;"),
                     ("g / gs", "g * gs"),
                     ("const float q = a_t / N;", "const float q = a_t * N;")]
# Variants of this PR's pair path (fb_pair_kernel).
_PAIR_LAUNCH = [("  const int n = T * K;\n  const int PL = static_cast<int>(row_pitch(n));\n",
                 "  if (T > 0) return;\n  const int n = T * K;\n"
                 "  const int PL = static_cast<int>(row_pitch(n));\n")]
_PAIR_NO_CHAINS = [("  if (warp == 0) {  // -- forward", "  if (false) {  // -- forward"),
                   ("  } else if (warp == 1) {  // -- backward",
                    "  } else if (false) {  // -- backward")]
_PAIR_NO_COMBINE = [("for (int t = warp * span; t < t_end; ++t) {",
                     "for (int t = warp * span; t < 0; ++t) {")]
_PAIR_NO_LOAD = [("async_copy::copy16(s_lik + i * PL + 4 * m, L + 4LL * e);",
                  "")]
_PAIR_NO_FLUSH = [("      *reinterpret_cast<float4*>(G + 4LL * e) =\n"
                   "          *reinterpret_cast<const float4*>(s_alpha + i * PL + 4 * m);\n", "")]
VARIANTS = {
    "k1 no sweep": ("lgssm_smooth.cu", [(
        "    sweep(row, row, s_xf + threadIdx.x * P, 1, T, s_coef, s_coef + T, s_coef + 2 * T,\n"
        "          h_over_r);\n", "")]),
    "k1 store only": ("lgssm_smooth.cu", [
        ("    sweep(row, row, s_xf + threadIdx.x * P, 1, T, s_coef, s_coef + T, s_coef + 2 * T,\n"
         "          h_over_r);\n", ""),
        ("if (q < count4) v[j] = y4[q];",
         "if (q < count4) v[j] = make_float4(1.f, 2.f, 3.f, 4.f);"),
        ("s_y[Pos(k, T).slot(P)] = y[base + k];", "s_y[Pos(k, T).slot(P)] = 1.f;"),
    ]),
    "hmm lik in registers": ("hmm_forward_backward.cu", _HMM_NO_LIK),
    "hmm no gamma stores": ("hmm_forward_backward.cu", _HMM_NO_GAMMA),
    "hmm lik in registers, no gamma stores": ("hmm_forward_backward.cu",
                                              _HMM_NO_LIK + _HMM_NO_GAMMA),
    "hmm counts without shuffles": ("hmm_forward_backward.cu", _HMM_NO_COUNT_SHUFFLES),
    "hmm divisions as multiplies": ("hmm_forward_backward.cu", _HMM_NO_DIVISIONS),
    "pair launch only": ("hmm_forward_backward.cu", _PAIR_LAUNCH),
    "pair no chains": ("hmm_forward_backward.cu", _PAIR_NO_CHAINS),
    "pair no combine": ("hmm_forward_backward.cu", _PAIR_NO_COMBINE),
    "pair no load": ("hmm_forward_backward.cu", _PAIR_NO_LOAD),
    "pair no flush": ("hmm_forward_backward.cu", _PAIR_NO_FLUSH),
    "k4 u in registers": ("hgf_filter.cu", _K4_NO_U),
    "k4 no track stores": ("hgf_filter.cu", _K4_NO_STORES),
    "k4 u in registers, no track stores": ("hgf_filter.cu", _K4_NO_U + _K4_NO_STORES),
    "k4 arithmetic only": ("hgf_filter.cu",
                           _K4_NO_U + _K4_NO_STORES + _K4_NO_TRACKS + _K4_NO_BARRIERS),
}


def emit(**fields) -> None:
    line = json.dumps(fields)
    print(line, flush=True)
    with open(os.path.join(OUT, "probe.jsonl"), "a") as f:
        f.write(line + "\n")


def import_other(root: str, name: str = OTHER_NAME):
    """Copy OTHER's package to build/probe/ as ``name`` and import it."""
    dst = os.path.join(WORK, name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(root, "cortex_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    if WORK not in sys.path:
        sys.path.insert(0, WORK)
    return import_package(name)


def import_package(name: str):
    """Import package ``name`` with the submodules this script reaches."""
    for sub in ("_build", "ops.kernels", "ops.kernels_hgf", "ops.kernels_hmm"):
        importlib.import_module(f"{name}.{sub}")
    return importlib.import_module(name)


def build_variants(pkg, names) -> dict:
    """Build one shared library per variant of ``pkg``'s sources, all nvcc runs
    at once; return {name: path}.  The edited sources are deleted after."""
    _build = pkg._build
    nvcc = _build.find_nvcc()
    jobs, libs = [], {}
    for index, name in enumerate(names):
        fname, edits = VARIANTS[name]
        vdir = os.path.join(WORK, f"variant{index}")
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        for header in _build.CSRC_DIR.glob("*.cuh"):
            shutil.copy(header, vdir)
        objs = []
        for src in _build.sources():
            text = src.read_text()
            if src.name == fname:
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"variant {name!r}: edit does not apply to {src.name}")
                    text = text.replace(old, new)  # every occurrence
            path = os.path.join(vdir, src.name)
            with open(path, "w") as f:
                f.write(text)
            obj = path + ".o"
            objs.append(obj)
            jobs.append((name, src.name, subprocess.Popen(
                _build.compile_command(nvcc, path, obj), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        libs[name] = (os.path.join(vdir, "lib.so"), objs, vdir)
    logs = {}
    for name, src, proc in jobs:
        out, _ = proc.communicate()
        logs.setdefault(name, "")
        logs[name] += f"== {src}\n{out}"
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build {src}:\n{out}")
    paths = {}
    for name, (lib, objs, vdir) in libs.items():
        subprocess.run(_build.link_command(nvcc, objs, lib), check=True)
        with open(os.path.join(OUT, f"ptxas {name}.log"), "w") as f:
            f.write(logs[name])
        for leftover in os.listdir(vdir):
            if leftover.endswith((".cu", ".cuh", ".o")):
                os.remove(os.path.join(vdir, leftover))
        paths[name] = lib
    return paths


def use_library(pkg, path) -> None:
    """Make ``pkg``'s kernel wrappers launch from the library at ``path``."""
    pkg.ops.kernels._library.cache_clear()
    pkg._build.load = lambda: ctypes.CDLL(path)


def time_in_turns(torch, smoke, fns: dict, flush, names) -> dict:
    """Device ms of each fn of ``fns`` (label -> fn), in turns: each label in
    order, then in reverse; returns {label: [ms, ms]}."""
    order = list(fns) + list(reversed(fns))
    samples = {label: [] for label in fns}
    for label in order:
        samples[label].append(smoke.device_ms(torch, fns[label], flush, names))
    return samples


def k1_rows(torch, smoke, packages: dict, flush, setups=None) -> None:
    for R, T in K1_SHAPES:
        y = torch.from_numpy(
            np.random.default_rng(R).normal(size=(R, T)).cumsum(-1).astype(np.float32)).cuda()
        fns = {}
        for label, pkg in packages.items():
            def fn(pkg=pkg, label=label):
                if setups:
                    setups[label]()
                return pkg.ops.kernels.lgssm_smooth_fused(y)
            fns[label] = fn
        outs = {label: fn() for label, fn in fns.items()}
        torch.cuda.synchronize()
        samples = time_in_turns(torch, smoke, fns, flush, ("smooth",))
        first = next(iter(outs.values()))
        for label, pair in samples.items():
            diff = float((outs[label].mean - first.mean).abs().max())
            emit(kernel="lgssm_smooth", R=R, T=T, tree=label, device_ms=pair,
                 mean_device_ms=statistics.mean(pair),
                 bound_ms=12 * R * T / smoke.HBM_BYTES_PER_S * 1e3,
                 max_abs_diff_mean_vs_first=diff)


def k4_rows(torch, smoke, packages: dict, flush, configs=K4_CONFIGS, setups=None) -> None:
    R, T = K4_SHAPE
    u = torch.from_numpy(smoke.hgf_data(R, T, "walk", seed=2)).cuda()
    for config, (tracks, bf16) in configs.items():
        dtype = torch.bfloat16 if bf16 else torch.float32
        fns = {}
        for label, pkg in packages.items():
            def fn(pkg=pkg, label=label):
                if setups:
                    setups[label]()
                return pkg.ops.kernels_hgf.hgf_filter_fused(u, tracks=tracks, track_dtype=dtype)
            fns[label] = fn
        outs = {label: fn() for label, fn in fns.items()}
        torch.cuda.synchronize()
        samples = time_in_turns(torch, smoke, fns, flush, ("hgf_filter",))
        first = next(iter(outs.values()))
        bound = smoke.hgf_bound(R, T, len(tracks), 2 if bf16 else 4)
        for label, pair in samples.items():
            diff = max(float((g - w).abs().max()) for g, w in zip(outs[label][0], first[0]))
            emit(kernel="hgf_filter", R=R, T=T, config=config, tree=label, device_ms=pair,
                 mean_device_ms=statistics.mean(pair), **bound,
                 max_abs_diff_finals_vs_first=diff)


def hmm_rows(torch, smoke, packages: dict, flush, shapes=HMM_SHAPES, setups=None,
             tag=None) -> None:
    """K2 and K3 of each package at each (R, T, K) of ``shapes``."""
    for R, T, K in shapes:
        lik, A, pi = (torch.from_numpy(a).cuda() for a in smoke.hmm_inputs(R, T, K, seed=R))
        for counts in (False, True):
            name = "hmm_fb_counts" if counts else "hmm_fb"
            fns = {}
            for label, pkg in packages.items():
                def fn(pkg=pkg, label=label, counts=counts):
                    if setups:
                        setups[label]()
                    k = pkg.ops.kernels_hmm
                    op = (k.hmm_forward_backward_counts_fused if counts
                          else k.hmm_forward_backward_fused)
                    return op(lik, A, pi)
                fns[label] = fn
            outs = {label: fn() for label, fn in fns.items()}
            torch.cuda.synchronize()
            samples = time_in_turns(torch, smoke, fns, flush, ("fb_",))
            first = next(iter(outs.values()))
            bound = smoke.hmm_bound(R, T, K, counts)
            for label, pair in samples.items():
                diff = float((outs[label].gamma - first.gamma).abs().max())
                emit(kernel=name, R=R, T=T, K=K, tree=label, path=tag, device_ms=pair,
                     mean_device_ms=statistics.mean(pair), **bound,
                     max_abs_diff_gamma_vs_first=diff)


def ts_rows(torch, smoke, packages: dict, flush) -> None:
    """The time-sharded passes of each package that has them at TS_SHAPE,
    each alone, then all three, and their plain version in float32 on the
    same block."""
    R, T = TS_SHAPE
    y = torch.from_numpy(
        np.random.default_rng(R).normal(size=(R, T)).cumsum(-1).astype(np.float32)).cuda()
    one, zero = torch.ones(R, device="cuda"), torch.zeros(R, device="cuda")
    params = (1.0, 1.0, 1.0, 1.0)
    for label, pkg in packages.items():
        try:
            kts = importlib.import_module(f"{pkg.__name__}.ops.kernels_time_sharded")
        except ImportError:
            continue

        def passes(kts=kts):
            sweep = kts.LocalSweep(y, *params, first=True, last=True)
            sweep.filter_total()
            sweep.filter_fillin(zero, zero)
            return sweep.smoother_fillin(one, zero, zero)

        def plain(kts=kts):
            sweep = kts.LocalSweep(y, *params, first=True, last=True)
            sweep._filter_total_plain()
            sweep._filter_fillin_plain(zero, zero)
            sweep._smoother_fillin_plain(one, zero, zero)
            return sweep.mean, sweep.variance

        got, want = passes(), plain()
        torch.cuda.synchronize()
        diff = max(float((g - w).abs().max()) for g, w in zip(got, want))
        segments, length = kts.plan(R, T)
        log = pkg._build.library_path().with_name(pkg._build.library_path().name + ".log")
        report = log.read_text().split("== lgssm_time_sharded.cu")[-1].split("== ")[0]
        emit(kernel="lgssm_time_sharded", tree=label, R=R, T=T, segments=segments,
             segment_length=length, max_abs_diff_vs_plain=diff,
             ptxas=[line for line in report.splitlines() if "registers" in line])
        total_bytes = 0
        for name, (kernel, nbytes) in TS_PASSES.items():
            ms = smoke.device_ms(torch, passes, flush, (kernel,))
            total_bytes += nbytes * R * T
            emit(kernel=f"lgssm_time_sharded {name}", tree=label, R=R, T=T, device_ms=ms,
                 bound_ms=nbytes * R * T / smoke.HBM_BYTES_PER_S * 1e3)
        names = tuple(kernel for kernel, _ in TS_PASSES.values())
        emit(kernel="lgssm_time_sharded all passes", tree=label, R=R, T=T,
             device_ms=smoke.device_ms(torch, passes, flush, names),
             bound_ms=total_bytes / smoke.HBM_BYTES_PER_S * 1e3,
             plain_device_ms=smoke.device_ms(torch, plain, flush, runs=3),
             plain="ops/kernels_time_sharded.py::LocalSweep's plain passes in float32")


def hmm_path_rows(torch, smoke, pkg, flush) -> None:
    """This tree's K2 and K3 at K=8 and 16 on each small-K path."""
    k = pkg.ops.kernels_hmm
    default = {"PAIR_K_MAX": k.PAIR_K_MAX}
    try:
        for tag, settings in HMM_PATHS.items():
            for name, value in {**default, **settings}.items():
                setattr(k, name, value)
            hmm_rows(torch, smoke, {"this": pkg}, flush, HMM_PATH_SHAPES, tag=tag)
    finally:
        for name, value in default.items():
            setattr(k, name, value)


def keep_sass(cuobjdump: str, path: str, out_name: str, pattern=None) -> None:
    """Write the SASS of the library at ``path`` to ``OUT/out_name``; with
    ``pattern``, only the functions whose name contains it."""
    dump = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
    text = dump.stdout or dump.stderr
    if pattern:
        parts = text.split("\t\tFunction : ")
        text = "".join("\t\tFunction : " + part for part in parts[1:]
                       if pattern in part.split("\n", 1)[0])
    with open(os.path.join(OUT, out_name), "w") as f:
        f.write(text)


def main() -> None:
    global OUT
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("compare", "breakdown"))
    parser.add_argument("other", nargs="+", help="root of another checkout")
    parser.add_argument("--out", default=OUT, help="directory for probe.jsonl and the reports")
    parser.add_argument("--kernels", default="k1,hmm,k4,ts",
                        help="comma-separated kernels to time: k1, hmm, k4, ts")
    args = parser.parse_args()
    OUT = os.path.abspath(args.out)
    which = set(args.kernels.split(","))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe.py needs a CUDA card")
    os.makedirs(OUT, exist_ok=True)
    os.makedirs(WORK, exist_ok=True)
    sys.path.insert(0, REPO)
    import chip_smoke as smoke

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    emit(device=torch.cuda.get_device_name(0), nvidia_smi=smi, mode=args.mode,
         torch=torch.__version__, cuda=torch.version.cuda)
    flush = torch.ones(64 * 2**20 // 4, device="cuda")  # 64 MB, beyond the 50 MB L2
    if args.mode == "compare":
        packages = {root: import_other(os.path.abspath(root), f"{OTHER_NAME}{i}")
                    for i, root in enumerate(args.other)}
        packages["this"] = import_package("cortex_tpu_torch")
        for pkg in packages.values():
            pkg.ops.kernels._library()
        if "k1" in which:
            k1_rows(torch, smoke, packages, flush)
        if "hmm" in which:
            hmm_rows(torch, smoke, packages, flush)
            hmm_path_rows(torch, smoke, packages["this"], flush)
        if "k4" in which:
            k4_rows(torch, smoke, packages, flush)
        if "ts" in which:
            ts_rows(torch, smoke, packages, flush)
        return

    other = import_other(os.path.abspath(args.other[0]))

    # breakdown: OTHER's kernels whole and with parts cut out.
    base = other._build.load()
    base_path = base._name
    cuobjdump = os.path.join(os.path.dirname(other._build.find_nvcc()), "cuobjdump")
    keep_sass(cuobjdump, base_path, "base.sass")
    keep_sass(cuobjdump, base_path, "base fb_small_kernel 4.sass", "fb_small_kernelILi4E")
    keep_sass(cuobjdump, base_path, "base fb_pair_kernel 4.sass", "fb_pair_kernelILi4E")
    shutil.copy(base_path + ".log", os.path.join(OUT, "ptxas base.log"))
    names = [name for name in VARIANTS if name.split()[0] in which]
    libs = {"base": base_path, **build_variants(other, names)}
    for name, path in libs.items():
        if name != "base":
            keep_sass(cuobjdump, path, f"{name}.sass", "ILi4E")
    # One package, its library switched before each call: each label is a variant.
    setups = {name: (lambda path=path: use_library(other, path)) for name, path in libs.items()}

    def of(kernel):
        return {name: other for name in libs if name == "base" or name.startswith(kernel)}

    if "k1" in which:
        k1 = of("k1")
        k1_rows(torch, smoke, k1, flush, {name: setups[name] for name in k1})
    for kernel in ("hmm", "pair"):
        if kernel in which:
            rows = of(kernel)
            hmm_rows(torch, smoke, rows, flush, setups={name: setups[name] for name in rows})
    if "k4" in which:
        k4 = of("k4")
        k4_rows(torch, smoke, k4, flush, setups={name: setups[name] for name in k4})

if __name__ == "__main__":
    main()
