"""Time the port's K1 (LGSSM sweep) and K4 (HGF filter) kernels on one CUDA card.

Run from the root of a checkout, on a machine with one CUDA card and nvcc::

    python3 kernel_probe.py compare OTHER...  # this tree's K1 and K4 against others'
    python3 kernel_probe.py breakdown OTHER   # OTHER's K1 and K4 with parts cut out

``OTHER`` is the root of another checkout of this repository, for example an
earlier commit unpacked with ``git archive`` into the git-ignored ``build/``.
Its ``cortex_tpu_torch`` package is copied to ``build/probe/`` under the name
``cortex_tpu_torch_other<i>`` and imported beside this tree's, so all run in
one process on one card.

``compare`` times K1 at 10,000 and 100,000 replicas x T=100 and K4 at 65,536
x 256 for three track sets (none, all five float32, mu1+mu2 bf16), each
kernel of every tree in turns (others, this, then the reverse), by the device
time that ``torch.profiler`` reports, and reports how far each tree's result
lies from the first's.

``breakdown`` builds variants of OTHER's two kernel sources with one part cut
out each, written as scratch sources under ``build/probe/`` (git-ignored) and
deleted after the build, and times them in turns the same way:
- K1: the sweep removed (load and store left), and the load removed too;
- K4: u made in registers instead of loaded, the track stores skipped, and
  both with the barriers removed (the step's arithmetic alone).
The variants are text edits of the kernels of commit c5860b3; on other
sources an edit that does not apply raises.  It also keeps the compiler's
register report and the SASS of each base kernel.

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
VARIANTS = {
    "k1 no sweep": ("lgssm_smooth.cu", [(
        "    sweep(row, row, s_xf + threadIdx.x * P, 1, T, s_coef, s_coef + T, s_coef + 2 * T,\n"
        "          h_over_r);\n", "")]),
    "k1 store only": ("lgssm_smooth.cu", [
        ("    sweep(row, row, s_xf + threadIdx.x * P, 1, T, s_coef, s_coef + T, s_coef + 2 * T,\n"
         "          h_over_r);\n", ""),
        ("if (q < count4) v[j] = y4[q];", "if (q < count4) v[j] = make_float4(1.f, 2.f, 3.f, 4.f);"),
        ("s_y[Pos(k, T).slot(P)] = y[base + k];", "s_y[Pos(k, T).slot(P)] = 1.f;"),
    ]),
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
    for sub in ("_build", "ops.kernels", "ops.kernels_hgf"):
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
        objs = []
        for src in _build.sources():
            text = src.read_text()
            if src.name == fname:
                for old, new in edits:
                    if old not in text:
                        raise RuntimeError(f"variant {name!r}: edit does not apply to {src.name}")
                    text = text.replace(old, new)
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
            if leftover.endswith((".cu", ".o")):
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


def main() -> None:
    global OUT
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("mode", choices=("compare", "breakdown"))
    parser.add_argument("other", nargs="+", help="root of another checkout")
    parser.add_argument("--out", default=OUT, help="directory for probe.jsonl and the reports")
    args = parser.parse_args()
    OUT = os.path.abspath(args.out)

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
        k1_rows(torch, smoke, packages, flush)
        k4_rows(torch, smoke, packages, flush)
        return

    other = import_other(os.path.abspath(args.other[0]))

    # breakdown: OTHER's kernels whole and with parts cut out.
    base = other._build.load()
    base_path = base._name
    cuobjdump = os.path.join(os.path.dirname(other._build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", base_path], capture_output=True, text=True)
    with open(os.path.join(OUT, "base.sass"), "w") as f:
        f.write(sass.stdout or sass.stderr)
    shutil.copy(base_path + ".log", os.path.join(OUT, "ptxas base.log"))
    libs = {"base": base_path, **build_variants(other, list(VARIANTS))}
    for name, path in libs.items():
        if name != "base":
            dump = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True)
            with open(os.path.join(OUT, f"{name}.sass"), "w") as f:
                f.write(dump.stdout or dump.stderr)
    # One package, its library switched before each call: each label is a variant.
    setups = {name: (lambda path=path: use_library(other, path)) for name, path in libs.items()}
    k1 = {name: other for name in libs if name == "base" or name.startswith("k1")}
    k4 = {name: other for name in libs if name == "base" or name.startswith("k4")}
    k1_rows(torch, smoke, k1, flush, {name: setups[name] for name in k1})
    k4_rows(torch, smoke, k4, flush, setups={name: setups[name] for name in k4})


if __name__ == "__main__":
    main()
