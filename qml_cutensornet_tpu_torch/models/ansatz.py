"""The kernel-state ansatz and its compilation to a static canonical op stream
(port of ``qml_cutensornet_tpu/models/ansatz.py``, numpy only).

The feature-map circuit ``U(x)|0..0>`` is: H on every qubit, then ``reps``
times an Rz(gamma * x_i) layer and XXPhase((pi/2) gamma^2 (1-x_i)(1-x_j))
for every pair (i, j) of the entanglement map, with SWAP routing so every
two-qubit gate acts on adjacent sites. The circuit STRUCTURE is the same for
every datapoint, so it is compiled once into a :class:`GateSchedule` of
integer arrays (site, gate kind, canonical-center direction, feature
indices); the angles are computed from the features at run time.

Only ``routing="tracked"`` (permutation-tracked routing, the reference's
default) is ported: swap-back chains are dropped, the engine keeps a map
from features to sites, and gates within a rep (all XXPhase terms commute)
run in a position-sorted sweep. Gram entries are invariant under the common
final permutation. ``"reference"`` and ``"brick"`` raise.

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


def build_schedule(
    num_qubits: int,
    reps: int,
    gamma: float,
    entanglement_map: list[tuple[int, int]],
    hadamard_init: bool = True,
    routing: str = "tracked",
) -> GateSchedule:
    if routing in ("reference", "brick"):
        raise NotImplementedError(f"routing={routing!r} is not ported; use 'tracked'")
    if routing != "tracked":
        raise ValueError(f"Unknown routing mode: {routing}")
    streams, pos_maps, final_pos = _raw_tracked(num_qubits, reps, entanglement_map)
    streams = [_fuse_stream(s) for s in streams]
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
    """API-parity ansatz class: stores the compiled :class:`GateSchedule`."""

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
