"""The kernel-state ansatz and its compilation to a static program (port of
``qml_cutensornet_tpu/models/ansatz.py``, numpy only).

The feature-map circuit ``U(x)|0..0>`` is: H on every qubit, then ``reps``
times an Rz(gamma * x_i) layer and XXPhase((pi/2) gamma^2 (1-x_i)(1-x_j))
for every pair (i, j) of the entanglement map, with SWAP routing so every
two-qubit gate acts on adjacent sites. The circuit STRUCTURE is the same for
every datapoint, so it is compiled once into a :class:`GateSchedule` of
integer arrays (site, gate kind, canonical-center direction, feature
indices); the angles are computed from the features at run time.

All three routings of the reference are ported. ``routing="tracked"``
(permutation-tracked, the reference's default) compiles a
:class:`GateSchedule`: swap-back chains are dropped, the engine keeps a map
from features to sites, and gates within a rep (all XXPhase terms commute)
run in a position-sorted sweep. ``routing="reference"`` compiles the
original paper's gate order into a :class:`GateSchedule` of the same form:
for each non-adjacent XXPhase a SWAP chain in, the gate, and the chain back
(:func:`_raw_reference`); it is the baseline tracked routing is judged
against. ``routing="brick"`` compiles a :class:`BrickSchedule` of brick
layers of disjoint two-site ops (a banded swap network, :func:`_raw_brick`)
for the Vidal/Hastings engine (``ops/vidal.py``). Gram entries are invariant
under the common final permutation.

Canonical-form lowering: the compiler tracks the orthogonality center,
inserts identity center moves (``GATE_I``) when the next gate is not
adjacent, and picks each update's placement direction by one-gate
lookahead.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Gate kinds in the lowered op stream.
GATE_I = 0  # identity two-site op (canonical-center move)
GATE_SWAP = 1
GATE_XX = 2
GATE_XXSW = 3  # fused XXPhase @ SWAP (= SWAP @ XXPhase; XX is exchange-symmetric)
GATE_ZZ = 4  # ZZPhase: in the reference gate set, never emitted by the ansatz
# Single-site kinds (>= GATE_RX): ``site`` is the qubit index; they never
# move the canonical center.
GATE_RX = 5
GATE_RZ1 = 6
GATE_H1 = 7

# Placement of the orthogonality center after a two-site update.
DIR_R = 0  # center ends at site+1
DIR_L = 1  # center ends at site


@dataclasses.dataclass
class RepSegment:
    """One repetition of the ansatz, lowered to adjacent-site operations.
    ``pos_to_feature[p]`` is the feature whose qubit sits at site ``p`` when
    the segment starts."""

    pos_to_feature: np.ndarray  # [n] int32
    sites: np.ndarray  # [g] int32 — left site of each 2-site op
    gkinds: np.ndarray  # [g] int32 — GATE_*
    dirs: np.ndarray  # [g] int32 — DIR_*
    fa: np.ndarray  # [g] int32 — feature index for the XX angle (0 otherwise)
    fb: np.ndarray  # [g] int32


@dataclasses.dataclass
class GateSchedule:
    num_qubits: int
    reps: int
    gamma: float
    hadamard_init: bool
    segments: list[RepSegment]
    final_pos: np.ndarray  # [n] int32 — site where original qubit q ends up
    routing: str

    @property
    def num_two_site_ops(self) -> int:
        return sum(len(s.sites) for s in self.segments)

    @property
    def num_gate_ops(self) -> int:
        return int(sum(np.sum(s.gkinds != GATE_I) for s in self.segments))


def _raw_reference(num_qubits, reps, entanglement_map):
    """Reference SWAP routing: for each pair, a SWAP chain in, the gate, and
    the chain back; one identical raw stream per rep, sites never permuted."""
    stream = []
    for (a, b) in entanglement_map:
        q0, q1 = min(a, b), max(a, b)
        for q in range(q0, q1 - 1):
            stream.append((q, GATE_SWAP, 0, 0))
        stream.append((q1 - 1, GATE_XX, a, b))
        for q in reversed(range(q0, q1 - 1)):
            stream.append((q, GATE_SWAP, 0, 0))
    pos_maps = [np.arange(num_qubits, dtype=np.int32)] * reps
    return [stream] * reps, pos_maps, np.arange(num_qubits, dtype=np.int32)


def _raw_tracked(num_qubits, reps, entanglement_map):
    """Permutation-tracked routing: move one qubit adjacent to the other and
    leave it there; within each rep, gates run in a position-sorted sweep."""
    n = num_qubits
    pos = np.arange(n, dtype=np.int64)  # pos[q] = current site of qubit q
    at = np.arange(n, dtype=np.int64)  # at[p] = qubit currently at site p
    streams, pos_maps = [], []
    for _ in range(reps):
        pos_maps.append(at.astype(np.int32).copy())
        stream = []
        order = sorted(entanglement_map, key=lambda ab: min(pos[ab[0]], pos[ab[1]]))
        for (a, b) in order:
            pa, pb = int(pos[a]), int(pos[b])
            lo, hi = (pa, pb) if pa < pb else (pb, pa)
            for p in range(lo, hi - 1):
                stream.append((p, GATE_SWAP, 0, 0))
                qa, qb = at[p], at[p + 1]
                at[p], at[p + 1] = qb, qa
                pos[qa], pos[qb] = p + 1, p
            stream.append((hi - 1, GATE_XX, a, b))
        streams.append(stream)
    return streams, pos_maps, pos.astype(np.int32)


def _fuse_stream(stream):
    """Peephole fusion over one raw rep stream: XXPhase next to a SWAP on the
    same pair becomes one GATE_XXSW; SWAP then SWAP cancels."""
    out = []
    for op in stream:
        if out:
            ps, pk, pfa, pfb = out[-1]
            s, k, fa, fb = op
            if ps == s:
                if {pk, k} == {GATE_XX, GATE_SWAP}:
                    xfa, xfb = (pfa, pfb) if pk == GATE_XX else (fa, fb)
                    out[-1] = (s, GATE_XXSW, xfa, xfb)
                    continue
                if pk == GATE_SWAP and k == GATE_SWAP:
                    out.pop()
                    continue
        out.append(op)
    return out


def _canonical_lower(streams, pos_maps, num_qubits):
    """Insert canonical-center moves and choose each update's placement
    direction by one-gate lookahead. The center starts undefined and
    persists across segments."""
    center = None
    segments = []
    for stream, pos_map in zip(streams, pos_maps):
        ops = []
        for idx, (s, gk, fa, fb) in enumerate(stream):
            if center is None:
                center = s
            while center < s:
                ops.append((center, GATE_I, DIR_R, 0, 0))
                center += 1
            while center > s + 1:
                ops.append((center - 1, GATE_I, DIR_L, 0, 0))
                center -= 1
            nxt = stream[idx + 1][0] if idx + 1 < len(stream) else s
            d = DIR_L if nxt < s else DIR_R
            ops.append((s, gk, d, fa, fb))
            center = s if d == DIR_L else s + 1
        arr = np.asarray(ops, dtype=np.int32).reshape(-1, 5)
        segments.append(
            RepSegment(
                pos_to_feature=np.asarray(pos_map, dtype=np.int32),
                sites=arr[:, 0].copy(),
                gkinds=arr[:, 1].copy(),
                dirs=arr[:, 2].copy(),
                fa=arr[:, 3].copy(),
                fb=arr[:, 4].copy(),
            )
        )
    return segments


@dataclasses.dataclass
class BrickRep:
    """One repetition lowered to brick LAYERS of disjoint two-site ops. Pair
    coordinates are in the PADDED site space: real site ``s`` sits at padded
    site ``s+1``; one dummy site on the left and one or two on the right give
    both parities exactly ``K`` pairs with disjoint gathers."""

    pos_to_feature: np.ndarray  # [n] int32 — feature at REAL site p at rep start
    parities: np.ndarray  # [L] int32 — padded-space parity of each layer
    swaps: np.ndarray  # [L] bool — layer is a swap-network step (XXSW ops)
    active: np.ndarray  # [L, K] bool — pair participates in the layer
    fire: np.ndarray  # [L, K] bool — pair applies its XXPhase angle
    fa: np.ndarray  # [L, K] int32 — feature indices for the angle
    fb: np.ndarray  # [L, K] int32


@dataclasses.dataclass
class BrickSchedule:
    """Brick-parallel program: per rep, an Rz feature layer, then swap-network
    brick layers that make every entanglement-map pair adjacent and fire it
    exactly once (fused XXPhase@SWAP on a meet, plain SWAP otherwise)."""

    num_qubits: int
    reps: int
    gamma: float
    hadamard_init: bool
    bricks: list[BrickRep]
    final_pos: np.ndarray  # [n] int32 — final site of original qubit q
    num_sites_padded: int
    pairs_per_layer: int
    routing: str = "brick"

    @property
    def num_two_site_ops(self) -> int:
        return int(sum(np.sum(r.active) for r in self.bricks))

    @property
    def num_layers(self) -> int:
        return int(sum(len(r.parities) for r in self.bricks))


def _raw_brick(num_qubits, reps, entanglement_map):
    """Banded windowed swap network (the reference's brick routing).

    With d the largest interaction distance, a full swap network on a window
    of w sites (w layers of alternating parity) makes every pair of window
    qubits adjacent once and reverses the window. Passes over the width-2d
    windows at offsets 0, 2d, ... (Wa) and at offset d (Wc, plus the leading
    partial window) from the same layout meet every map pair. Even reps run
    A, A' (restore), C; odd reps C' (restore), A, A'. A pair's XXPhase is
    fused into its SWAP the first time it meets in a rep; the compiler replays
    the permutation and asserts that every map pair fires exactly once per
    rep. d == 1 needs no routing (two plain XX layers per rep); 2d >= n is the
    full reversal network on [0, n)."""
    n = num_qubits
    if not entanglement_map:
        raise ValueError("Brick routing needs a non-empty entanglement map.")
    d = max(abs(a - b) for (a, b) in entanglement_map)
    map_set = {(min(a, b), max(a, b)) for (a, b) in entanglement_map}
    n_p = n + (3 if n % 2 == 0 else 2)
    K = (n_p - 1) // 2
    at = np.arange(n, dtype=np.int64)  # at[p] = qubit at real site p

    if 2 * d >= n:
        wa = [(0, n)]
        wc = [(0, n)]
    else:
        wa = [(s, min(s + 2 * d, n)) for s in range(0, n, 2 * d)]
        wc = [(0, d)] + [(s, min(s + 2 * d, n)) for s in range(d, n, 2 * d)]
        wc = [(s, e) for (s, e) in wc if e - s >= 2]

    bricks = []
    for rep in range(reps):
        pos_to_feature = at.astype(np.int32).copy()
        fired: set = set()
        layers: list = []

        def make_layers(pair_sites, swap):
            """Layer(s) for a disjoint list of REAL left sites, one per parity
            present (odd d mixes parities; disjoint pairs commute)."""
            for par_real in (0, 1):
                sites = [s for s in pair_sites if s % 2 == par_real]
                if not sites:
                    continue
                par_pad = (par_real + 1) % 2
                act = np.zeros(K, bool)
                fr = np.zeros(K, bool)
                fa = np.zeros(K, np.int32)
                fb = np.zeros(K, np.int32)
                for s in sites:
                    k = (s + 1 - par_pad) // 2
                    act[k] = True
                    qa, qb = int(at[s]), int(at[s + 1])
                    key = (min(qa, qb), max(qa, qb))
                    if key in map_set and key not in fired:
                        fired.add(key)
                        fr[k] = True
                        fa[k], fb[k] = qa, qb
                    if swap:
                        at[s], at[s + 1] = at[s + 1], at[s]
                layers.append((par_pad, swap, act, fr, fa, fb))

        def emit_pass(windows):
            width = max(e - s for (s, e) in windows)
            for step in range(width):
                pair_sites = []
                for (ws, we) in windows:
                    if step >= we - ws:
                        continue  # short window: its network is done
                    pair_sites.extend(range(ws + (step % 2), we - 1, 2))
                if pair_sites:
                    make_layers(pair_sites, swap=True)

        if d == 1:
            make_layers(list(range(0, n - 1, 2)), swap=False)
            make_layers(list(range(1, n - 1, 2)), swap=False)
        elif 2 * d >= n:
            emit_pass(wa)
        elif rep % 2 == 0:
            emit_pass(wa)
            emit_pass(wa)
            emit_pass(wc)
        else:
            emit_pass(wc)
            emit_pass(wa)
            emit_pass(wa)
        missing = map_set - fired
        assert not missing, f"brick schedule missed pairs {sorted(missing)[:5]}"

        bricks.append(BrickRep(
            pos_to_feature=pos_to_feature,
            parities=np.asarray([l[0] for l in layers], np.int32),
            swaps=np.asarray([l[1] for l in layers], bool),
            active=np.stack([l[2] for l in layers]),
            fire=np.stack([l[3] for l in layers]),
            fa=np.stack([l[4] for l in layers]),
            fb=np.stack([l[5] for l in layers]),
        ))

    pos = np.empty(n, dtype=np.int32)  # pos[q] = final site of qubit q
    pos[at] = np.arange(n, dtype=np.int32)
    return bricks, pos


def build_schedule(
    num_qubits: int,
    reps: int,
    gamma: float,
    entanglement_map: list[tuple[int, int]],
    hadamard_init: bool = True,
    routing: str = "tracked",
) -> GateSchedule | BrickSchedule:
    if routing == "brick":
        bricks, final_pos = _raw_brick(num_qubits, reps, entanglement_map)
        n_p = num_qubits + (3 if num_qubits % 2 == 0 else 2)
        return BrickSchedule(
            num_qubits=num_qubits,
            reps=reps,
            gamma=float(gamma),
            hadamard_init=hadamard_init,
            bricks=bricks,
            final_pos=final_pos,
            num_sites_padded=n_p,
            pairs_per_layer=(n_p - 1) // 2,
        )
    if routing == "reference":
        streams, pos_maps, final_pos = _raw_reference(num_qubits, reps, entanglement_map)
    elif routing == "tracked":
        streams, pos_maps, final_pos = _raw_tracked(num_qubits, reps, entanglement_map)
        streams = [_fuse_stream(s) for s in streams]
    else:
        raise ValueError(f"Unknown routing mode: {routing}")
    segments = _canonical_lower(streams, pos_maps, num_qubits)
    return GateSchedule(
        num_qubits=num_qubits,
        reps=reps,
        gamma=float(gamma),
        hadamard_init=hadamard_init,
        segments=segments,
        final_pos=final_pos,
        routing=routing,
    )


class KernelStateAnsatz:
    """API-parity ansatz class: stores the compiled :class:`GateSchedule` or
    :class:`BrickSchedule`. :meth:`circuit_for_data` gives one datapoint's
    bound circuit as a gate list, for ``models/simulate.simulate_gate_list``
    and for cross-checks; the engine itself never builds per-datapoint
    circuits."""

    def __init__(
        self,
        num_qubits: int,
        reps: int,
        gamma: float,
        entanglement_map: list[tuple[int, int]],
        hadamard_init: bool = True,
        routing: str = "tracked",
    ):
        self.num_qubits = num_qubits
        self.reps = reps
        self.gamma = gamma
        self.entanglement_map = [(int(a), int(b)) for (a, b) in entanglement_map]
        self.hadamard_init = hadamard_init
        self.schedule = build_schedule(
            num_qubits, reps, gamma, self.entanglement_map, hadamard_init, routing
        )

    def circuit_for_data(self, feature_values):
        """Lowered gate list with bound parameters, ``[(name, qubits,
        params), ...]``, in the reference CPU backend's tuple format and
        pytket half-turn exponents, with the REFERENCE routing whatever the
        schedule's."""
        x = np.asarray(feature_values, dtype=np.float64)
        if len(x) != self.num_qubits:
            raise RuntimeError("The number of values must match the number of symbols.")
        gates: list[tuple[str, list[int], list[float]]] = []
        if self.hadamard_init:
            for q in range(self.num_qubits):
                gates.append(("H", [q], []))
        for _ in range(self.reps):
            for q in range(self.num_qubits):
                gates.append(("Rz", [q], [float((2 / np.pi) * self.gamma * x[q])]))
            for (a, b) in self.entanglement_map:
                q0, q1 = min(a, b), max(a, b)
                exponent = float(self.gamma**2 * (1 - x[a]) * (1 - x[b]))
                for q in range(q0, q1 - 1):
                    gates.append(("SWAP", [q, q + 1], []))
                gates.append(("XXPhase", [q1 - 1, q1], [exponent]))
                for q in reversed(range(q0, q1 - 1)):
                    gates.append(("SWAP", [q, q + 1], []))
        return gates
