"""Memory-evolution tracker (port of the reference ``cli/main_track_mem``).

Simulates ONE datapoint circuit (the train point at index argv[10]) op by op
and writes the unpadded MPS size to stderr after every op of the schedule,
as ``[DEBUG] MPS size (MiB) = <x>``: the line ``runs/mem_evol/plot.py``
parses (the value after the '='). Then prints ``Final fidelity:`` and ``Max
bond dimension:``. The byte count is read back after every op, one device
sync per op: this is a diagnostic tool. ``QMLTPU_DEVICE`` picks the device
(default cuda). Each op runs at the configuration's ambient class
(``cfg.matmul_precision``), as the reference runs its op step under
``jax.default_matmul_precision``; the Hadamard layer, which the reference
applies outside that context, runs at full precision.

    python -m qml_cutensornet_tpu_torch.cli.main_track_mem GPU 100 2 1.0 6 \\
        5 5 5 elliptic_preproc.csv 0
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.models.simulate import apply_schedule_op
from qml_cutensornet_tpu_torch.ops import gates, mps as mps_ops
from qml_cutensornet_tpu_torch.utils.device import resolve_device


def simulate_with_mem_log(schedule, features, cfg, device: str = "cuda", log=None):
    """Evolve one circuit of a tracked or reference-routed schedule at
    ``cfg.chi``, op by op, writing the unpadded MiB of the state after every
    op to ``log`` (default stderr). Returns the final MPS (a batch of one)."""
    if log is None:
        log = sys.stderr
    dev = resolve_device(device)
    rdt = cfg.real_dtype
    np_rdt = np.dtype(str(rdt).removeprefix("torch."))
    itemsize = torch.empty((), dtype=cfg.complex_dtype).element_size()
    x = np.asarray(features, dtype=np.float64)
    gamma = schedule.gamma
    state = mps_ops.zero_state(1, schedule.num_qubits, cfg, dev)
    if schedule.hadamard_init:
        state = mps_ops.apply_1q_all(state, gates.hadamard(rdt, dev))
    for seg in schedule.segments:
        xs = torch.as_tensor(x[None, seg.pos_to_feature].astype(np_rdt), device=dev)
        state = mps_ops.apply_diag_all(state, gates.rz_phases(gamma * xs))
        thetas = 0.5 * np.pi * gamma * gamma * (1.0 - x[seg.fa]) * (1.0 - x[seg.fb])
        thetas = torch.as_tensor(thetas.astype(np_rdt), device=dev)
        for g in range(len(seg.sites)):
            state = apply_schedule_op(state, int(seg.sites[g]), int(seg.gkinds[g]),
                                      int(seg.dirs[g]), thetas[g:g + 1], cfg)
            mib = float(mps_ops.actual_nbytes(state, itemsize)[0]) / (1024**2)
            print(f"[DEBUG] MPS size (MiB) = {mib}", file=log)
            log.flush()
    return state


def main(argv=None):
    argv = sys.argv if argv is None else argv
    params = pipe.parse_argv(argv)
    if len(argv) <= 10:
        raise ValueError("main_track_mem requires an extra <circ_index> argument.")
    circ_index = int(argv[10])
    pipe.echo_params(params, n_procs=1)
    x_train, _, _, _ = pipe.prepare(params)
    ansatz = pipe.make_ansatz(params)
    cfg = pipe.sim_config(params)
    state = simulate_with_mem_log(ansatz.schedule, x_train[circ_index], cfg,
                                  device=pipe.engine_kwargs()["device"])
    print(f"Final fidelity: {float(state.fidelity[0])}")
    print(f"Max bond dimension: {int(mps_ops.max_bond(state)[0])}")
    return state


if __name__ == "__main__":
    main()
