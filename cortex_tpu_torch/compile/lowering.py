"""Chain lowering: reroll repeated linear schedule structure into a scan loop.

The generic schedule extractor (:mod:`cortex_tpu_torch.compile.schedule`) phases a
chain-structured factor graph — the reference's flagship LGSSM topology
(Cortex.jl's ``test/inference_engine_tests.jl:379-488``) — into O(T)
single-step phases: correct, but a T-step chain becomes T phases of
batched calls.  The hand-written model zoo avoids this with a scan
(:mod:`cortex_tpu_torch.ops.chains`); this pass closes the gap for *arbitrary* user
graphs by detecting the unrolled-loop structure in the extracted schedule and
re-rolling it:

1. **Classes** — color every scheduled step by ``(rule key, dependency
   producer keys, weak mask)``.  Steps of one color execute the same rule on
   the same wiring shape.
2. **Sequences** — within a class, mine the unique-successor relation
   (``s -> s'`` when ``s'`` consumes ``s`` through a short path of
   other-class steps).  Maximal paths of length >= ``MIN_RUN`` are linear
   recurrences — e.g. the forward products ``MessageToFactor(x_i -> trans_i)``
   the BP resolver wires per the reference ``src/dependencies.jl:17-31``.
3. **Bundles** — union sequences connected by dependencies (a chain's
   product sequence + its transition-message sequence), then certify every
   dependency of every element as one of: *intra* (same iteration, fixed
   producer sequence), *carry* (fixed lookback k >= 1; the first k elements
   read pre-run signals, which become the scan carry init), *xs* (external,
   varies per iteration — a stacked scan input), or *const* (external, same
   signal every iteration).  Independent same-shape bundles merge into one
   scan, so a chain's forward and backward recursions execute in a single
   scan loop.
4. **Re-phase** the remaining steps around the scan segments (longest-path
   levels over the coarse segment DAG), preserving the original orientation
   of every weak (VMP) edge so stale-read semantics match the unrolled
   executor exactly.

Everything is verification-gated: any wiring that does not certify falls
back to the batched phase executor unchanged, so lowering is a pure
performance transform (validated by ``tests/test_fuzz_equivalence.py``).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from .schedule import (
    ComputeStep,
    PhaseGroup,
    StaticSchedule,
    _variant_order_key as _order_key,
)

__all__ = ["ScanClass", "ScanSegment", "LoweredPlan", "lower_schedule"]

MIN_RUN = 4  # shortest sequence worth a scan
MAX_HOPS = 4  # max path length (edges) for the class-successor relation
MAX_FRONTIER = 96  # successor BFS size cap (dense graphs are not chains)


@dataclasses.dataclass
class ScanClass:
    """One batched rule call per scan iteration: ``len(seqs)`` parallel
    sequences of the same color, executed as a group of that size.

    Dependency spec forms (per sequence, per dependency position):

    - ``("const", signal)`` — captured from the value table (same signal
      every iteration);
    - ``("xs", [signal_0, ..., signal_{L-1}])`` — stacked scan input;
    - ``("intra", class_idx, seq_idx)`` — same-iteration producer;
    - ``("carry", class_idx, seq_idx, k)`` — producer k iterations back.
    """

    key: Tuple  # rule key (PhaseGroup.key)
    seqs: List[List[ComputeStep]]  # [seq][iteration]
    dep_specs: List[List[Tuple]]  # [seq][dep position] -> spec
    emit_ys: List[bool]  # per seq: outputs needed outside the scan


@dataclasses.dataclass
class ScanSegment:
    """One scan loop over ``length`` iterations of ``classes`` (listed in
    intra-iteration topological order)."""

    length: int
    classes: List[ScanClass]
    # (class_idx, seq_idx) -> window size K (max lookback among consumers)
    carry_window: Dict[Tuple[int, int], int]
    # (class_idx, seq_idx) -> K pre-run signals; index j = virtual element
    # -(j+1) (the value read by a lookback-(j+1) consumer at iteration 0)
    carry_init: Dict[Tuple[int, int], List[Any]]

    @property
    def num_steps(self) -> int:
        return self.length * sum(len(c.seqs) for c in self.classes)


@dataclasses.dataclass
class LoweredPlan:
    """Ordered execution segments: ``("phase", [PhaseGroup])`` or
    ``("scan", ScanSegment)``."""

    segments: List[Tuple[str, Any]]

    @property
    def scan_segments(self) -> List[ScanSegment]:
        return [seg for kind, seg in self.segments if kind == "scan"]

    def summary(self) -> str:
        lines = [f"LoweredPlan: {len(self.segments)} segments"]
        for kind, seg in self.segments:
            if kind == "scan":
                lines.append(
                    f"  scan: length={seg.length}, classes="
                    + ", ".join(f"{c.key[0]}x{len(c.seqs)}" for c in seg.classes)
                )
            else:
                parts = ", ".join(f"{g.key[0]}x{len(g.steps)}" for g in seg)
                lines.append(f"  phase: {parts}")
        return "\n".join(lines)


def _cmp(a, b) -> int:
    return (a > b) - (a < b)


def lower_schedule(
    schedule: StaticSchedule, emit_all: bool = False
) -> Optional[LoweredPlan]:
    """Attempt to lower ``schedule`` into scan segments.

    Returns ``None`` when nothing certifies (the caller keeps the plain
    phased execution).  A returned plan computes exactly the same signal
    values in an order equivalent to the phased executor's (weak-edge read
    orientation preserved).

    ``emit_all``: emit every lowered sequence as scan ys (not just signals
    consumed outside their scan) so the value table covers ALL scheduled
    signals after one plan sweep — required by ``fixed_point``'s carry,
    which snapshots every signal.  Costs extra stacked outputs; default off
    for plain ``run``/``iterate`` sweeps."""
    steps: List[ComputeStep] = []
    phase_of: Dict[int, int] = {}
    key_of: Dict[int, Tuple] = {}
    for pi, phase in enumerate(schedule.phases):
        for g in phase:
            for st in g.steps:
                steps.append(st)
                phase_of[id(st.signal)] = pi
                key_of[id(st.signal)] = g.key
    if len(steps) < 2 * MIN_RUN:
        return None
    produced: Dict[int, ComputeStep] = {id(st.signal): st for st in steps}

    # -- 1. colors -----------------------------------------------------------
    classes: Dict[Tuple, List[ComputeStep]] = defaultdict(list)
    for st in steps:
        color = (
            key_of[id(st.signal)],
            tuple(key_of.get(id(d), "__ext__") for d in st.deps),
            st.weak_mask,
        )
        classes[color].append(st)

    dependents: Dict[int, List[ComputeStep]] = defaultdict(list)
    for st in steps:
        for d in st.deps:
            if id(d) in produced:
                dependents[id(d)].append(st)

    # -- 2. sequences --------------------------------------------------------
    sequences: List[Tuple[Tuple, List[ComputeStep]]] = []  # (color, path)
    for color, members in classes.items():
        if len(members) < MIN_RUN:
            continue
        for path in _mine_sequences(members, dependents):
            if len(path) >= MIN_RUN:
                sequences.append((color, path))
    if not sequences:
        return None

    # Global registries: signal id -> owning sequence index / position.
    seq_idx_of: Dict[int, int] = {}
    pos_of: Dict[int, int] = {}
    for si, (_, path) in enumerate(sequences):
        for pos, st in enumerate(path):
            seq_idx_of[id(st.signal)] = si
            pos_of[id(st.signal)] = pos

    # -- 3. bundles (union-find over dependency-connected sequences) ---------
    parent = list(range(len(sequences)))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for si, (_, path) in enumerate(sequences):
        for st in path:
            for d in st.deps:
                sj = seq_idx_of.get(id(d))
                if sj is not None and find(sj) != find(si):
                    parent[find(sj)] = find(si)

    bundles: Dict[int, List[int]] = defaultdict(list)
    for si in range(len(sequences)):
        bundles[find(si)].append(si)

    verified: List[ScanSegment] = []
    for seq_ids in bundles.values():
        seg = _verify_bundle(
            [sequences[i] for i in seq_ids], pos_of, phase_of
        )
        if seg is not None:
            verified.append(seg)
    if not verified:
        return None

    lowered_ids = _index_segments(verified)

    # -- merge independent same-shape segments into one scan ------------------
    verified = _merge_segments(verified, lowered_ids)
    lowered_ids = _index_segments(verified)

    # -- ys: outputs needed outside their scan --------------------------------
    keep: set = set()
    for sig in schedule.targets.values():
        keep.add(id(sig))
    for sigs in schedule.linked.values():
        keep.update(id(s) for s in sigs)
    keep.update(id(s) for s in schedule.initials)
    for st in steps:
        here = lowered_ids.get(id(st.signal))
        for d in st.deps:
            owner = lowered_ids.get(id(d))
            if owner is not None and (here is None or here[0] != owner[0]):
                keep.add(id(d))
    for seg in verified:
        for cls in seg.classes:
            for qi, path in enumerate(cls.seqs):
                cls.emit_ys[qi] = emit_all or any(
                    id(st.signal) in keep for st in path
                )

    # -- 4. coarse ordering: segments + rest steps ----------------------------
    return _build_plan(steps, key_of, verified, lowered_ids, produced, phase_of)


def _index_segments(segments) -> Dict[int, Tuple[int, int, int]]:
    out: Dict[int, Tuple[int, int, int]] = {}
    for si, seg in enumerate(segments):
        for ci, cls in enumerate(seg.classes):
            for qi, path in enumerate(cls.seqs):
                for st in path:
                    out[id(st.signal)] = (si, ci, qi)
    return out


def _mine_sequences(members, dependents) -> List[List[ComputeStep]]:
    """Split a class into maximal unique-successor paths (or nothing)."""
    cls_ids = {id(st.signal) for st in members}
    succ: Dict[int, ComputeStep] = {}
    pred: set = set()
    for st in members:
        found: List[ComputeStep] = []
        seen = {id(st.signal)}
        frontier = [st.signal]
        for _ in range(MAX_HOPS):
            if not frontier:
                break
            nxt = []
            for sig in frontier:
                for dst in dependents.get(id(sig), ()):
                    did = id(dst.signal)
                    if did in seen:
                        continue
                    seen.add(did)
                    if did in cls_ids:
                        found.append(dst)
                    else:
                        nxt.append(dst.signal)
            if len(seen) > MAX_FRONTIER:
                return []
            frontier = nxt
        if len(found) > 1:
            return []  # ambiguous successor: not a linear recurrence
        if found:
            nid = id(found[0].signal)
            if nid in pred:
                return []  # two predecessors converge: not linear
            succ[id(st.signal)] = found[0]
            pred.add(nid)
    paths: List[List[ComputeStep]] = []
    for st in members:
        if id(st.signal) in pred:
            continue  # not a path head
        path = [st]
        cur = st
        while id(cur.signal) in succ:
            cur = succ[id(cur.signal)]
            path.append(cur)
        paths.append(path)
    return paths


def _verify_bundle(
    seqs: List[Tuple[Tuple, List[ComputeStep]]],
    pos_of: Dict[int, int],
    phase_of: Dict[int, int],
) -> Optional[ScanSegment]:
    """Certify a bundle of sequences as one scan; None on any violation."""
    L = len(seqs[0][1])
    if any(len(path) != L for _, path in seqs):
        return None

    # Group sequences by color -> classes (insertion order is deterministic).
    by_color: Dict[Tuple, List[List[ComputeStep]]] = {}
    for color, path in seqs:
        by_color.setdefault(color, []).append(path)
    colors = list(by_color.keys())
    # signal id -> (class idx, seq idx within class)
    member: Dict[int, Tuple[int, int]] = {}
    for ci, color in enumerate(colors):
        for qi, path in enumerate(by_color[color]):
            for st in path:
                member[id(st.signal)] = (ci, qi)

    carry_window: Dict[Tuple[int, int], int] = {}
    carry_init_sigs: Dict[Tuple[int, int], Dict[int, Any]] = defaultdict(dict)
    intra_edges: set = set()  # (producer class, consumer class)
    all_specs: List[List[List[Tuple]]] = []  # [class][seq][dep]

    for ci, color in enumerate(colors):
        cls_specs: List[List[Tuple]] = []
        for path in by_color[color]:
            ndeps = len(path[0].deps)
            if any(len(st.deps) != ndeps for st in path):
                return None
            specs: List[Tuple] = []
            for d in range(ndeps):
                entries = [st.deps[d] for st in path]
                spec = _classify_dep(entries, member, pos_of)
                if spec is None:
                    return None
                if spec[0] == "carry":
                    _, pc, pq, k = spec
                    slot = (pc, pq)
                    carry_window[slot] = max(carry_window.get(slot, 0), k)
                    for j in range(k):
                        virt = k - j  # 1-based distance back at iteration j
                        prev = carry_init_sigs[slot].get(virt)
                        if prev is None:
                            carry_init_sigs[slot][virt] = entries[j]
                        elif prev is not entries[j]:
                            return None  # inconsistent carry init
                elif spec[0] == "intra":
                    intra_edges.add((spec[1], ci))
                specs.append(spec)
            cls_specs.append(specs)
        all_specs.append(cls_specs)

    # Intra-iteration class DAG -> topological order.
    order = _topo_classes(len(colors), intra_edges)
    if order is None:
        return None
    topo_pos = {ci: p for p, ci in enumerate(order)}

    # Weak-edge orientation inside the bundle must match the phased order.
    for ci, color in enumerate(colors):
        for path in by_color[color]:
            for i, st in enumerate(path):
                for d, dep in enumerate(st.deps):
                    if not st.weak_mask[d]:
                        continue
                    hit = member.get(id(dep))
                    if hit is None:
                        continue
                    scan_cmp = _cmp(
                        (pos_of[id(dep)], topo_pos[hit[0]]),
                        (i, topo_pos[ci]),
                    )
                    orig_cmp = _cmp(
                        phase_of[id(dep)], phase_of[id(st.signal)]
                    )
                    if scan_cmp != orig_cmp:
                        return None

    # Assemble: classes in topo order, spec class indices remapped.
    remap = {old: new for new, old in enumerate(order)}
    cls_list: List[ScanClass] = []
    for old_ci in order:
        color = colors[old_ci]
        paths = by_color[color]
        specs = [
            [_remap_spec(s, remap) for s in seq_specs]
            for seq_specs in all_specs[old_ci]
        ]
        cls_list.append(
            ScanClass(
                key=color[0],
                seqs=[list(p) for p in paths],
                dep_specs=specs,
                emit_ys=[False] * len(paths),
            )
        )
    new_window = {(remap[c], q): k for (c, q), k in carry_window.items()}
    new_init: Dict[Tuple[int, int], List[Any]] = {}
    for (c, q), sigs in carry_init_sigs.items():
        slot = (remap[c], q)
        k = new_window[slot]
        init = [sigs[v] for v in sorted(sigs)]
        # Unread virtual slots pad with the nearest read signal (the padding
        # value is never consumed; it only keeps the window shape uniform).
        while len(init) < k:
            init.append(init[-1])
        new_init[slot] = init[:k]
    if set(new_init) != set(new_window):
        return None
    return ScanSegment(
        length=L,
        classes=cls_list,
        carry_window=new_window,
        carry_init=new_init,
    )


def _classify_dep(entries, member, pos_of) -> Optional[Tuple]:
    """Classify one dependency position of one sequence; None on violation."""
    hits = [member.get(id(e)) for e in entries]
    if all(h is None for h in hits):
        first = entries[0]
        if all(e is first for e in entries):
            return ("const", first)
        return ("xs", list(entries))
    prod = next(h for h in hits if h is not None)
    first_i = next(i for i, h in enumerate(hits) if h is not None)
    k = first_i - pos_of[id(entries[first_i])]
    if k < 0:
        return None
    for i, (e, h) in enumerate(zip(entries, hits)):
        if i < k:
            if h is not None:
                return None  # pre-window entries must be pre-run signals
        else:
            if h != prod or pos_of[id(e)] != i - k:
                return None
    if k == 0:
        return ("intra", prod[0], prod[1])
    return ("carry", prod[0], prod[1], k)


def _topo_classes(n, edges) -> Optional[List[int]]:
    indeg = [0] * n
    out: Dict[int, List[int]] = defaultdict(list)
    for a, b in edges:
        if a == b:
            return None
        out[a].append(b)
        indeg[b] += 1
    frontier = [i for i in range(n) if indeg[i] == 0]
    order: List[int] = []
    while frontier:
        a = frontier.pop()
        order.append(a)
        for b in out[a]:
            indeg[b] -= 1
            if indeg[b] == 0:
                frontier.append(b)
    return order if len(order) == n else None


def _remap_spec(spec, remap):
    if spec[0] == "intra":
        return ("intra", remap[spec[1]], spec[2])
    if spec[0] == "carry":
        return ("carry", remap[spec[1]], spec[2], spec[3])
    return spec


def _deps_on(seg: ScanSegment, members: set, lowered_ids) -> bool:
    """True if any step of ``seg`` depends on a signal owned by a segment
    index in ``members``."""
    for cls in seg.classes:
        for path in cls.seqs:
            for st in path:
                for d in st.deps:
                    owner = lowered_ids.get(id(d))
                    if owner is not None and owner[0] in members:
                        return True
    return False


def _merge_segments(segments, lowered_ids) -> List[ScanSegment]:
    """Merge *independent* segments with equal length and identical class-key
    tuples by concatenating per-class sequence lists (so a chain's forward
    and backward recursions run in one fused scan)."""
    groups: Dict[Tuple, List[int]] = defaultdict(list)
    for i, seg in enumerate(segments):
        sig = (seg.length, tuple(c.key for c in seg.classes))
        groups[sig].append(i)
    merged: List[ScanSegment] = []
    for idxs in groups.values():
        base_idx = idxs[0]
        base = segments[base_idx]
        members = {base_idx}
        for other_idx in idxs[1:]:
            other = segments[other_idx]
            if _deps_on(other, members, lowered_ids) or _deps_on(
                base, {other_idx}, lowered_ids
            ):
                merged.append(other)  # dependent: keep separate
                continue
            members.add(other_idx)
            # Per-class sequence-index shift (computed BEFORE extending).
            shift = {ci: len(base.classes[ci].seqs) for ci in range(len(base.classes))}
            for ci, cls in enumerate(base.classes):
                ocls = other.classes[ci]
                for seq_specs in ocls.dep_specs:
                    cls.dep_specs.append(
                        [_shift_spec(s, shift) for s in seq_specs]
                    )
                cls.seqs.extend(ocls.seqs)
                cls.emit_ys.extend(ocls.emit_ys)
            for (ci, qi), k in other.carry_window.items():
                base.carry_window[(ci, qi + shift[ci])] = k
                base.carry_init[(ci, qi + shift[ci])] = other.carry_init[(ci, qi)]
        merged.append(base)
    return merged


def _shift_spec(spec, shift):
    if spec[0] == "intra":
        return ("intra", spec[1], spec[2] + shift[spec[1]])
    if spec[0] == "carry":
        return ("carry", spec[1], spec[2] + shift[spec[1]], spec[3])
    return spec


def _build_plan(
    steps, key_of, segments, lowered_ids, produced, phase_of
) -> Optional[LoweredPlan]:
    """Order scan segments and remaining steps into executable levels.

    Constraint edges: strong dependencies (producer before consumer) plus
    weak dependencies oriented exactly as the phased executor ran them
    (producer phase < consumer phase keeps the producer first; the reverse
    keeps the *consumer* first so it still reads the stale value)."""

    def node_of(sig_id):
        hit = lowered_ids.get(sig_id)
        return ("seg", hit[0]) if hit is not None else ("step", sig_id)

    edges: Dict[Tuple, set] = defaultdict(set)
    nodes: set = {("seg", i) for i in range(len(segments))}
    for st in steps:
        n = node_of(id(st.signal))
        nodes.add(n)
        for d, dep in enumerate(st.deps):
            if id(dep) not in produced:
                continue
            m = node_of(id(dep))
            if m == n:
                continue
            if not st.weak_mask[d]:
                edges[m].add(n)
            else:
                c = _cmp(phase_of[id(dep)], phase_of[id(st.signal)])
                if c < 0:
                    edges[m].add(n)
                elif c > 0:
                    edges[n].add(m)

    indeg: Dict[Tuple, int] = {n: 0 for n in nodes}
    for m, outs in edges.items():
        for n in outs:
            indeg[n] += 1
    frontier = [n for n in nodes if indeg[n] == 0]
    level: Dict[Tuple, int] = {n: 0 for n in frontier}
    done = 0
    while frontier:
        m = frontier.pop()
        done += 1
        for n in edges.get(m, ()):
            level[n] = max(level.get(n, 0), level[m] + 1)
            indeg[n] -= 1
            if indeg[n] == 0:
                frontier.append(n)
    if done != len(nodes):
        return None  # ordering cycle: give up on lowering entirely

    steps_by_id = {id(st.signal): st for st in steps}
    max_level = max(level.values(), default=0)
    out_segments: List[Tuple[str, Any]] = []
    for lv in range(max_level + 1):
        rest_here: Dict[Tuple, List[ComputeStep]] = {}
        scans_here: List[int] = []
        for n, nlv in level.items():
            if nlv != lv:
                continue
            if n[0] == "seg":
                scans_here.append(n[1])
            else:
                rest_here.setdefault(key_of[n[1]], []).append(steps_by_id[n[1]])
        if rest_here:
            # Variant-sorted step order (schedule._variant_order_key): keeps
            # pack rows in model order so downstream smart_stack consumption
            # lowers to slices/reverses instead of gathers.
            out_segments.append(
                (
                    "phase",
                    [
                        PhaseGroup(
                            k, sorted(sts, key=lambda st: _order_key(st.signal))
                        )
                        for k, sts in rest_here.items()
                    ],
                )
            )
        for si in sorted(scans_here):
            out_segments.append(("scan", segments[si]))
    return LoweredPlan(out_segments)
