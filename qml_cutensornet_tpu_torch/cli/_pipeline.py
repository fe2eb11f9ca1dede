"""Shared CLI pipeline: argv parsing, engine config, data prep, Gram builds
(port of ``qml_cutensornet_tpu/cli/_pipeline.py``).

The positional contract is the reference's:

    python -m qml_cutensornet_tpu_torch.cli.main_no_test <backend> <num_features>
        <layers> <gamma> <distance> <n_illicit> <n_licit> <data_seed> <data_file>

``backend`` is GPU, CPU or TPU; it selects the truncation criterion name
only ("cutoff" for CPU, else "fidelity"; the rule is the same). Knobs
without a positional slot come from the environment, with the reference's
names where the port supports them:

    QMLTPU_DEVICE          cuda | cpu (default cuda; cuda without a card
                           raises, it never falls back)
    QMLTPU_CHI             bond cap (default min(2^(nq//2), 64)); "auto"
                           probes a sample of the train features with
                           utils/autotune.choose_chi at chi 8, 16, ... until
                           the smallest sample fidelity reaches
                           QMLTPU_FID_TARGET (default 1-1e-9), no bond
                           saturates, or the next probe would pass
                           QMLTPU_AUTO_CHI_MAX (default 256); the sample is
                           the first QMLTPU_AUTO_SAMPLE (default 8) points,
                           and the train and test Grams of one run share the
                           choice
    QMLTPU_PRECISION       f32 | f64 (default f32)
    QMLTPU_SVD             subspace (default; kernels K1 to K5) | svd | eigh
                           (torch.linalg: cuSOLVER on the card)
    QMLTPU_SUBSPACE_ITERS  power iterations (default 2)
    QMLTPU_OVERSAMPLE      subspace oversampling (default 16 at chi >= 128)
    QMLTPU_POWER_PRECISION  the subspace power products' precision, and
    QMLTPU_TILE_PRECISION   the Gram tiles' and state norms': inherit
                           (default: the full f32 of the engine) | highest |
                           float32 (full f32) | high | bfloat16_3x |
                           tensorfloat32 (three bf16 passes) | bfloat16 |
                           default (one bf16 pass); a reduced class runs on
                           kernel K7 (ops/lowp.py), full f64 under
                           QMLTPU_PRECISION=f64; a power precision other
                           than inherit keeps the split off K1, K4 and K5
    QMLTPU_TILE_BLOCK      sites per tile-scan step (default 2 at chi <= 128)
    QMLTPU_FUSED_SPLIT     1 (default): split by kernel K1, center move by K2;
                           0: the unfused chain (kernel K3 + matrix products)
    QMLTPU_FUSED_GATE      1: two-site updates by kernel K4 (default 0)
    QMLTPU_ROUTING         tracked (default) | reference (the original gate
                           order: SWAP chain in, gate, chain back) | brick
                           (the Vidal/Hastings brick engine; with
                           QMLTPU_FUSED_GATE=1 its pair updates run in
                           kernel K5)
    QMLTPU_CHECKPOINT      1: per-tile checkpoint and resume of each Gram in
                           tmp/checkpoint_<run name>.npy
    QMLTPU_CKPT_INTERVAL   least seconds between checkpoint saves (default 0:
                           after every tile)
    QMLTPU_SIM_BATCH       circuits per batch (default 32)
    QMLTPU_TILE            Gram tile side (default 32)
    QMLTPU_MGS_PAIR        1: the block-2 in-panel step in kernels K1 to K5
                           (SimConfig.mgs_pair; default 0, as in the
                           reference)
    QMLTPU_BRICK_CAPS      1: the brick engine's structural bond caps (each
                           layer's pairs updated at their caps' sliced
                           shapes; SimConfig.brick_struct_caps; default 0)
    QMLTPU_MESH            device count of the multi-device Gram build (the
                           ring of parallel/gram.py), one process per device:
                           under torchrun (WORLD_SIZE in the environment; or
                           parallel.mesh.launch) every Gram runs on the ring
                           over the process group, NCCL on cuda, gloo on
                           cpu; unset, it is the world size (no ring with
                           QMLTPU_SHARD_MPS), and any other value raises.
                           Outside a process group a value above 1 raises
                           (run torchrun --nproc-per-node N -m
                           qml_cutensornet_tpu_torch.cli.main ...); it
                           never runs on one device instead. Every rank
                           builds the same K; only rank 0 writes files
    QMLTPU_RING            stepwise (default; one ring iteration at a time,
                           timed, checkpointed with QMLTPU_CHECKPOINT=1 in
                           tmp/checkpoint_ring_<run name>.npz) | fused (the
                           same loop with no device sync between iterations:
                           only the aggregate time, no checkpoint)
    QMLTPU_SHARD_MPS       "all" | N: the brick engine (QMLTPU_ROUTING=brick;
                           any other routing raises) shards each state's
                           sites over the process group
                           (parallel/sharded_mps.py; torchrun
                           --nproc-per-node N, one process per device), or
                           runs a mesh of one outside a group with "all"; N
                           must equal the world size, and N > 1 outside a
                           group raises. The process group is then the site
                           mesh and not a ring: with QMLTPU_MESH > 1 it
                           raises, and the Gram's tiles run on every rank
                           from the gathered MPS
    QMLTPU_STAGED, QMLTPU_CHUNK_LEN, QMLTPU_NORMALIZE  as in the reference
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys

import numpy as np
import torch.distributed as dist

from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.parallel.mesh import make_mesh, maybe_distributed_init, process_index
from qml_cutensornet_tpu_torch.parallel.sharded_mps import mesh_for_knob
from qml_cutensornet_tpu_torch.utils.autotune import choose_chi
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare
from qml_cutensornet_tpu_torch.utils.naming import run_info

INPUT_ERROR_MSG = (
    "\nCall script as 'python main.py <backend> <num_features> <layers> <gamma> "
    "<distance> <n_illicit> <n_licit> <data_seed> <data_file>'."
    "\nThe value of <backend> must be GPU, CPU or TPU."
)

# The truncation error assigned to the simulation (reference main.py:73).
TRUNCATION_ERROR = 1e-16

# QMLTPU_CHI=auto choices, so that the train and test Grams of one run share
# one probe sequence.
_auto_chi_cache: dict = {}


@dataclasses.dataclass
class RunParams:
    backend: str
    num_features: int
    reps: int
    gamma: float
    nearest_neighbors: int
    n_illicit: int
    n_licit: int
    data_seed: int
    data_file: str

    @property
    def entanglement_map(self):
        return entanglement_graph(nq=self.num_features, nn=self.nearest_neighbors)


def _env_flag(name: str, default: str = "0") -> bool:
    return os.environ.get(name, default) != "0"


def parse_argv(argv=None) -> RunParams:
    argv = sys.argv if argv is None else argv
    if len(argv) <= 9:
        raise ValueError(INPUT_ERROR_MSG)
    backend = str(argv[1])
    if backend not in ("GPU", "CPU", "TPU"):
        raise ValueError(INPUT_ERROR_MSG)
    return RunParams(
        backend=backend,
        num_features=int(argv[2]),
        reps=int(argv[3]),
        gamma=float(argv[4]),
        nearest_neighbors=int(argv[5]),
        n_illicit=int(argv[6]),
        n_licit=int(argv[7]),
        data_seed=int(argv[8]),
        data_file=str(argv[9]),
    )


def default_chi(num_features: int) -> int:
    return int(min(2 ** (num_features // 2), 64))


def sim_config(params: RunParams, sample_features=None) -> SimConfig:
    """The engine config from the environment. ``QMLTPU_CHI=auto`` needs
    ``sample_features`` (the train features; :func:`build` passes them) and
    probes the cap on its first ``QMLTPU_AUTO_SAMPLE`` rows with the
    configuration's other knobs (oversampling as set, else 0)."""
    tb_env = os.environ.get("QMLTPU_TILE_BLOCK")
    base = SimConfig(
        chi=1,
        truncation_error=TRUNCATION_ERROR,
        criterion="cutoff" if params.backend == "CPU" else "fidelity",
        precision=os.environ.get("QMLTPU_PRECISION", "f32"),
        svd_method=os.environ.get("QMLTPU_SVD", "subspace"),
        subspace_iters=int(os.environ.get("QMLTPU_SUBSPACE_ITERS", 2)),
        oversample=int(os.environ.get("QMLTPU_OVERSAMPLE", 0)),
        power_precision=os.environ.get("QMLTPU_POWER_PRECISION", "inherit"),
        tile_precision=os.environ.get("QMLTPU_TILE_PRECISION", "inherit"),
        fused_split=_env_flag("QMLTPU_FUSED_SPLIT", "1"),
        fused_gate=_env_flag("QMLTPU_FUSED_GATE"),
        mgs_pair=_env_flag("QMLTPU_MGS_PAIR"),
        brick_struct_caps=_env_flag("QMLTPU_BRICK_CAPS"),
        tile_block=int(tb_env) if tb_env is not None else 2,
    )
    chi_env = os.environ.get("QMLTPU_CHI")
    if chi_env == "auto":
        chi = _auto_chi(params, base, sample_features)
    elif chi_env is not None:
        chi = int(chi_env)
    else:
        chi = default_chi(params.num_features)
    over_env = os.environ.get("QMLTPU_OVERSAMPLE")
    oversample = int(over_env) if over_env is not None else (16 if chi >= 128 else 0)
    tile_block = int(tb_env) if tb_env is not None else (2 if chi <= 128 else 1)
    return dataclasses.replace(base, chi=chi, oversample=oversample, tile_block=tile_block)


def _auto_chi(params: RunParams, base: SimConfig, sample_features) -> int:
    """The QMLTPU_CHI=auto choice, probed once per run configuration."""
    if sample_features is None:
        raise ValueError("QMLTPU_CHI=auto needs sample features (call via build()).")
    target = float(os.environ.get("QMLTPU_FID_TARGET", 1.0 - 1e-9))
    sample = np.asarray(sample_features)[: int(os.environ.get("QMLTPU_AUTO_SAMPLE", 8))]
    memo_key = (dataclasses.astuple(params), base, target, sample.shape)
    chi = _auto_chi_cache.get(memo_key)
    if chi is None:
        chi = choose_chi(
            make_ansatz(params).schedule,
            sample,
            dataclasses.replace(base, chi=8),
            fidelity_target=target,
            chi_max=int(os.environ.get("QMLTPU_AUTO_CHI_MAX", 256)),
            verbose=True,
            device=os.environ.get("QMLTPU_DEVICE", "cuda"),
        )
        _auto_chi_cache[memo_key] = chi
        print(f"QMLTPU_CHI=auto selected chi={chi}")
    return chi


def engine_kwargs() -> dict:
    device = os.environ.get("QMLTPU_DEVICE", "cuda")
    kwargs = dict(
        sim_batch=int(os.environ.get("QMLTPU_SIM_BATCH", 32)),
        tile=int(os.environ.get("QMLTPU_TILE", 32)),
        checkpoint=os.environ.get("QMLTPU_CHECKPOINT", "0") == "1",
        device=device,
    )
    size = os.environ.get("QMLTPU_MESH")
    shard = os.environ.get("QMLTPU_SHARD_MPS", "0")
    if shard != "0":
        # The process group is the site mesh; the Gram's tiles take the
        # single-device path on every rank, from the gathered MPS.
        if size is not None and int(size) > 1:
            raise ValueError(f"QMLTPU_SHARD_MPS with QMLTPU_MESH={size}: the site-sharded "
                             "engine runs on no ring (no dp x sp mesh behind the knobs)")
        routing = os.environ.get("QMLTPU_ROUTING", "tracked")
        if routing != "brick":
            raise ValueError(f"QMLTPU_SHARD_MPS={shard} shards the brick engine's sites, but "
                             f"QMLTPU_ROUTING={routing}: set QMLTPU_ROUTING=brick")
        kwargs["site_mesh"] = mesh_for_knob(shard, device)
        return kwargs
    if "WORLD_SIZE" in os.environ:
        maybe_distributed_init(device)
        kwargs["mesh"] = make_mesh(None if size is None else int(size), device)
    elif size is not None and int(size) > 1:
        raise RuntimeError(
            f"QMLTPU_MESH={size} needs one process per device: run under torchrun "
            f"--nproc-per-node {size} -m qml_cutensornet_tpu_torch.cli.main ...")
    return kwargs


def n_procs(engine: dict) -> int:
    """Ranks of the run: the size of the ring or site mesh over the process
    group that :func:`engine_kwargs` initializes under torchrun, else 1.
    ``engine`` is that call's result."""
    mesh = engine.get("mesh")
    if mesh is not None:
        return mesh.size
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes the run's files: rank 0 only, so that the
    ranks of one host do not race on the same file."""
    return process_index() == 0


def make_ansatz(params: RunParams) -> KernelStateAnsatz:
    return KernelStateAnsatz(
        num_qubits=params.num_features,
        reps=params.reps,
        gamma=params.gamma,
        entanglement_map=params.entanglement_map,
        hadamard_init=True,
        routing=os.environ.get("QMLTPU_ROUTING", "tracked"),
    )


def echo_params(params: RunParams, n_procs: int) -> None:
    """Parameter echo in the reference's format."""
    print("\nUsing the following parameters:")
    print("")
    print(f"\tn_procs: {n_procs}")
    print(f"\tbackend: {params.backend}")
    print("")
    print(f"\tnum_features: {params.num_features}")
    print(f"\treps: {params.reps}")
    print(f"\tgamma: {params.gamma}")
    print(f"\tinteraction distance: {params.nearest_neighbors}")
    print(f"\tentanglement_map: {params.entanglement_map}")
    print("")
    print(f"\tn_illicit: {params.n_illicit}")
    print(f"\tn_licit: {params.n_licit}")
    print("")
    print(f"\tdata_seed: {params.data_seed}")
    print(f"\tdata_file: {params.data_file}")
    print("")
    sys.stdout.flush()


def prepare(params: RunParams):
    return load_and_prepare(
        "datasets/" + params.data_file,
        params.num_features,
        params.n_illicit,
        params.n_licit,
        params.data_seed,
    )


def info_names(params: RunParams):
    args = (
        params.num_features,
        params.reps,
        params.gamma,
        params.nearest_neighbors,
        params.n_illicit,
        params.data_seed,
        params.data_file,
    )
    return run_info("train", *args), run_info("test", *args)


def build(params: RunParams, ansatz, X, engine: dict, Y=None, info_file=None):
    """The Gram of ``X`` (against ``Y``) on ``engine``, the result of
    :func:`engine_kwargs`."""
    pathlib.Path("kernels").mkdir(exist_ok=True)
    pathlib.Path("data").mkdir(exist_ok=True)
    return build_kernel_matrix(
        ansatz,
        X=np.asarray(X),
        Y=None if Y is None else np.asarray(Y),
        info_file=info_file,
        truncation_error=TRUNCATION_ERROR,
        cfg=sim_config(params, sample_features=X),
        loglevel=20,
        **engine,
    )
