"""The port's multi-device Gram build (``parallel/mesh``, ``parallel/gram``,
``parallel/dryrun``) on the CPU over gloo, against the JAX reference's ring
on its 8-device virtual CPU mesh.

Size: the reference's own distributed test (``tests/test_distributed.py``):
5 qubits, r 2, d 2, gamma 0.8, chi 4, f64, X 19 points and Y 11 from
``default_rng(0)``. Each world size is one launch (``mesh.launch``, one
process a rank) that makes several builds (``dryrun.run_calls``); world size
1 runs in this process.

- the ring schedule against the reference's formulas, ndev 1 to 8;
- symmetric and rectangular at world sizes 1, 2 and 3, against the
  reference's ``build_kernel_matrix_sharded`` on ``make_mesh(ndev)`` and
  against the port's single-device build, both at 1e-10 (f64 roundoff of an
  untruncated run);
- ``QMLTPU_RING=fused`` (the ring without per-iteration syncs) equal to
  the stepwise ring at world size 2, with only the aggregate time;
- a ring snapshot the reference wrote after iteration 0 resumes in the port
  at world size 4 (1e-10; the file is gone afterwards), and the port's own
  snapshot of that iteration equals the reference's;
- the unfused route (K3's plain version) and the brick route (K5's plain
  version, 6 qubits) on the ring in f32, against the port's single-device
  build at 3e-5 (the reference's fused-vs-unfused Gram bar);
- the profiling JSON has the reference's key set;
- ``cli.main_no_test`` at world size 2 (4 features, 4 + 4 points, f64):
  rank 0 writes the kernel file, equal to the single-process run's at 1e-10;
- the dry run at world size 2 (its own 2e-6 bar);
- no fallback: ``QMLTPU_MESH=2`` outside a process group raises, and so
  does a CUDA mesh without a card."""

import concurrent.futures
import json
import os
import pathlib
import socket

import numpy as np
import pytest
import torch.distributed as dist

import qml_cutensornet_tpu as q
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.parallel import gram as ref_pgram
from qml_cutensornet_tpu.parallel.mesh import make_mesh as ref_make_mesh
from qml_cutensornet_tpu_torch.cli import _pipeline, main_no_test
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.parallel import dryrun, mesh
from qml_cutensornet_tpu_torch.parallel import gram as pgram
from qml_cutensornet_tpu_torch.utils.data import preprocess_elliptic

ROOT = pathlib.Path(__file__).resolve().parents[1]
NQ, REPS, NN, GAMMA = 5, 2, 2, 0.8
CLI_ARGV = ["main", "GPU", "4", "2", "1.0", "1", "4", "4", "1", "v1.csv"]
CLI_ENV = {"QMLTPU_DEVICE": "cpu", "QMLTPU_PRECISION": "f64"}
CLI_KERNEL = "kernels/train_Nf4_r2_g1.0_p0.0_nn1_mslinear_Ntr4_s1_v1.npy"
F32_ROUTES = {
    # K3's plain version: the reference's fused-kernel ring case, unfused
    "unfused": (dict(nq=NQ, routing="tracked"),
                dict(chi=16, precision="f32", svd_method="subspace", subspace_iters=1)),
    # K5's plain version on the brick engine
    "brick": (dict(nq=6, routing="brick"),
              dict(chi=8, precision="f32", svd_method="subspace", subspace_iters=1,
                   fused_split=True, fused_gate=True)),
}


def _data():
    rng = np.random.default_rng(0)
    return rng.uniform(0, 2, size=(19, NQ)), rng.uniform(0, 2, size=(11, NQ))


def _ansatz(nq=NQ, routing="tracked"):
    return KernelStateAnsatz(nq, REPS, GAMMA, entanglement_graph(nq, NN), routing=routing)


def _route_points(nq):
    return np.random.default_rng(1).uniform(0, 2, size=(12, nq))


def _build(X, env=None, **kwargs):
    return (pgram.build_kernel_matrix_sharded, (_ansatz(), X),
            dict(cfg=SimConfig(chi=4, precision="f64"), mesh=dryrun.MESH, **kwargs), env or {})


def _route_call(name):
    akw, ckw = F32_ROUTES[name]
    return (pgram.build_kernel_matrix_sharded, (_ansatz(**akw), _route_points(akw["nq"])),
            dict(cfg=SimConfig(**ckw), mesh=dryrun.MESH), {})


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference: single-device Grams, its ring on meshes of 2 and 3,
    its profiling JSON, and its ring snapshot after iteration 0 on 4."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from qml_cutensornet_tpu.models.simulate import make_chunked_simulator
    from qml_cutensornet_tpu.parallel.mesh import AXIS

    assert len(jax.devices()) == 8
    tmp = tmp_path_factory.mktemp("ref")
    X, Y = _data()
    ansatz = q.KernelStateAnsatz(NQ, REPS, GAMMA, q.entanglement_graph(NQ, NN))
    cfg = RefConfig(chi=4, precision="f64")
    out = {"K": q.build_kernel_matrix(ansatz, X, truncation_error=1e-16, cfg=cfg),
           "K_xy": q.build_kernel_matrix(ansatz, X, Y=Y, truncation_error=1e-16, cfg=cfg)}
    for ndev in (2, 3):
        m = ref_make_mesh(ndev)
        info = str(tmp / "ref_sym") if ndev == 2 else None
        out[("sym", ndev)] = ref_pgram.build_kernel_matrix_sharded(ansatz, X, cfg=cfg, mesh=m,
                                                                   info_file=info)
        out[("rect", ndev)] = ref_pgram.build_kernel_matrix_sharded(ansatz, X, Y=Y, cfg=cfg,
                                                                    mesh=m)
    out["json"] = json.loads((tmp / "ref_sym.json").read_text())

    # The snapshot a ring build leaves after iteration 0 on 4 devices, as
    # the reference's own resume test writes it.
    m4 = ref_make_mesh(4)
    x_pad, _ = ref_pgram._pad_rows(np.asarray(X, dtype=np.float64), 4)
    sim_out = make_chunked_simulator(ansatz.schedule, cfg, mesh=m4)(x_pad)
    step = ref_pgram.make_ring_steps(m4, 4 // 2 + 1, True, cfg.matmul_precision)
    k0 = jax.device_put(np.zeros((x_pad.shape[0],) * 2, dtype=np.float64),
                        NamedSharding(m4, P(None, AXIS)))
    _, k1 = step(0, sim_out.tensors, sim_out.tensors, k0)
    ckdir = tmp / "ckpt"
    ckdir.mkdir()
    out["snapshot"] = np.asarray(k1)
    np.savez(ckdir / "checkpoint_ring_ring_ckpt.npz", k=out["snapshot"], next_iter=1)
    out["ckdir"] = ckdir
    return out


@pytest.fixture(scope="module")
def single():
    """The port's single-device builds of the same inputs."""
    X, Y = _data()
    cfg = SimConfig(chi=4, precision="f64")
    out = {"K": build_kernel_matrix(_ansatz(), X, cfg=cfg, device="cpu"),
           "K_xy": build_kernel_matrix(_ansatz(), X, Y=Y, cfg=cfg, device="cpu")}
    for name, (akw, ckw) in F32_ROUTES.items():
        out[name] = build_kernel_matrix(_ansatz(**akw), _route_points(akw["nq"]),
                                        cfg=SimConfig(**ckw), device="cpu")
    return out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """One launch per world size, several builds in each (rank 0's
    results)."""
    X, Y = _data()
    work = tmp_path_factory.mktemp("ring")
    (work / "datasets").mkdir()
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"),
                        str(work / "datasets/v1.csv"))
    calls = {
        2: [_build(X, info_file=str(work / "port_sym")), _build(X, Y=Y),
            _build(X, info_file=str(work / "port_fused"), env={"QMLTPU_RING": "fused"}),
            _build(X, Y=Y, env={"QMLTPU_RING": "fused"}),
            (main_no_test.main, (list(CLI_ARGV),), {}, CLI_ENV),
            (dryrun.dryrun_rank, ("cpu",), {}, {})],
        3: [_build(X), _build(X, Y=Y), _route_call("unfused"), _route_call("brick")],
        4: [(dryrun.ring_snapshot, (_ansatz(), X, SimConfig(chi=4, precision="f64")),
             dict(mesh=dryrun.MESH, info_file="port_snap", checkpoint_dir=str(work / "snap"),
                  sim_batch=32), {}),
            _build(X, info_file=str(work / "ring_ckpt"), checkpoint=True,
                   checkpoint_dir=str(ref["ckdir"]))],
    }
    old = os.getcwd()
    os.chdir(work)  # the spawned ranks start here
    try:
        # The three groups run at once (each on its own port).
        with concurrent.futures.ThreadPoolExecutor(len(calls)) as pool:
            futures = {ws: pool.submit(mesh.launch, dryrun.run_calls, ws, "cpu", "cpu", c)
                       for ws, c in calls.items()}
            out = {ws: [r["out"] for r in f.result()] for ws, f in futures.items()}
    finally:
        os.chdir(old)
    out["work"] = work
    return out


@pytest.mark.parametrize("ndev", range(1, 9))
def test_ring_schedule(ndev):
    for symmetric in (True, False):
        n_iters = ndev // 2 + 1 if symmetric else ndev
        plans = [pgram.ring_schedule(ndev, symmetric, r) for r in range(ndev)]
        for r, plan in enumerate(plans):
            assert len(plan) == n_iters
            rows = []
            for s in plan:
                assert s.y_block == (r + s.i) % ndev
                assert s.shift == (s.i + 1 < n_iters)
                mirror = symmetric and s.i > 0 and not (ndev % 2 == 0 and s.i == n_iters - 1)
                assert s.mirror == mirror
                rows.append(s.y_block)
                if s.mirror:
                    assert s.mirror_src == (r - s.i) % ndev
                    # what this rank sends at step i (to the owner of column
                    # stripe y_block) is what that peer expects
                    assert plans[s.y_block][s.i].mirror_src == r
                    rows.append(s.mirror_src)
            # every row block of the rank's column stripe, exactly once
            assert sorted(rows) == list(range(ndev))


@pytest.mark.parametrize("ws", [2, 3])
def test_symmetric_matches_reference(ref, single, runs, ws):
    K = runs[ws][0]
    assert K.shape == (19, 19)
    np.testing.assert_allclose(K, ref[("sym", ws)], atol=1e-10)
    np.testing.assert_allclose(K, single["K"], atol=1e-10)


@pytest.mark.parametrize("ws", [2, 3])
def test_rectangular_matches_reference(ref, single, runs, ws):
    K = runs[ws][1]
    assert K.shape == (11, 19)
    np.testing.assert_allclose(K, ref[("rect", ws)], atol=1e-10)
    np.testing.assert_allclose(K, single["K_xy"], atol=1e-10)


def test_fused_equals_stepwise(runs):
    np.testing.assert_allclose(runs[2][2], runs[2][0], atol=1e-12)
    np.testing.assert_allclose(runs[2][3], runs[2][1], atol=1e-12)
    # fused: no per-iteration samples, every product statistic the aggregate
    step = json.loads((runs["work"] / "port_sym.json").read_text())
    fused = json.loads((runs["work"] / "port_fused.json").read_text())
    assert set(fused) == set(step)
    stats = ("avg_product", "median_product", "q1_product", "q3_product")
    assert len({fused[k][0] for k in stats}) == 1
    assert fused["avg_product"][0] == pytest.approx(
        fused["kernel_mat_time"][0] / (20 * 20 // 2) * 2)


def test_cross_package_resume(ref, runs):
    snap = np.load(runs[4][0])
    assert int(snap["next_iter"]) == 1
    np.testing.assert_allclose(snap["k"], ref["snapshot"], atol=1e-10)
    np.testing.assert_allclose(runs[4][1], ref["K"], atol=1e-10)
    assert not (ref["ckdir"] / "checkpoint_ring_ring_ckpt.npz").exists()


@pytest.mark.parametrize("route", list(F32_ROUTES))
def test_other_routes_on_the_ring(single, runs, route):
    K = runs[3][2 + list(F32_ROUTES).index(route)]
    assert K.shape == (12, 12)
    np.testing.assert_allclose(K, single[route], atol=3e-5)


def test_profiling_json_keys(ref, runs):
    prof = json.loads((runs["work"] / "port_sym.json").read_text())
    assert set(prof) == set(ref["json"])
    assert prof["n_procs"] == [2, "devices"] and prof["lenX"] == [19, "entries"]
    assert prof["stats_semantics"] == ref["json"]["stats_semantics"]
    assert prof["ave max chi x"][0] == pytest.approx(ref["json"]["ave max chi x"][0])
    assert prof["avg_fidelity"][0] == pytest.approx(ref["json"]["avg_fidelity"][0], abs=1e-12)


def test_cli_world_size_two(runs, tmp_path, monkeypatch):
    for key, value in CLI_ENV.items():
        monkeypatch.setenv(key, value)
    for key in ("WORLD_SIZE", "QMLTPU_MESH"):
        monkeypatch.delenv(key, raising=False)
    (tmp_path / "datasets").mkdir()
    monkeypatch.chdir(tmp_path)
    preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
    K1 = main_no_test.main(list(CLI_ARGV))
    K2 = np.load(runs["work"] / CLI_KERNEL)
    np.testing.assert_array_equal(K2, runs[2][4])
    assert K2.shape == K1.shape and K1.shape[0] > 2
    np.testing.assert_allclose(K2, K1, atol=1e-10)


def test_dryrun_world_size_two(runs):
    out = runs[2][5]
    assert out["sym"]["shape"] == [7, 7] and out["rect"]["shape"] == [3, 7]
    assert out["deep_r8"]["shape"] == [4, 4]
    assert max(v["max_abs_err"] for v in out.values()) <= dryrun.TOL


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_world_size_one_in_process(ref, single, monkeypatch, tmp_path):
    """World size 1 (no transfers) in this process over gloo: symmetric,
    rectangular, a snapshot and its resume, and the CLI's mesh rules inside
    a group."""
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    assert mesh.maybe_distributed_init("cpu")
    try:
        m = mesh.make_mesh(device="cpu")
        assert (m.rank, m.size, m.device.type, m.AXIS) == (0, 1, "cpu", "dp")
        X, Y = _data()
        cfg = SimConfig(chi=4, precision="f64")
        K = build_kernel_matrix(_ansatz(), X, cfg=cfg, mesh=m, device="cpu")
        np.testing.assert_allclose(K, ref["K"], atol=1e-10)
        np.testing.assert_allclose(K, single["K"], atol=1e-10)
        K_xy = pgram.build_kernel_matrix_sharded(_ansatz(), X, Y=Y, cfg=cfg, mesh=m)
        np.testing.assert_allclose(K_xy, ref["K_xy"], atol=1e-10)
        # resume on a mesh of one: the Y fast-forward is the identity
        info = str(tmp_path / "one")
        snap = dryrun.ring_snapshot(_ansatz(), X, cfg, m, info, checkpoint_dir=str(tmp_path))
        assert snap.is_file()
        K_res = pgram.build_kernel_matrix_sharded(_ansatz(), X, cfg=cfg, mesh=m, info_file=info,
                                                  checkpoint=True, checkpoint_dir=str(tmp_path))
        np.testing.assert_array_equal(K_res, K)
        assert not snap.exists()
        with pytest.raises(ValueError, match="process group has 1"):
            mesh.make_mesh(2, device="cpu")
        with pytest.raises(RuntimeError, match="is_available"):
            mesh.make_mesh(device="cuda")
        with pytest.raises(ValueError, match="mesh runs on"):
            build_kernel_matrix(_ansatz(), X, cfg=cfg, mesh=m, device="cuda")
        assert _pipeline.engine_kwargs()["mesh"].size == 1
        monkeypatch.setenv("QMLTPU_MESH", "2")
        with pytest.raises(ValueError, match="process group has 1"):
            _pipeline.engine_kwargs()
    finally:
        dist.destroy_process_group()


def test_no_fallback_outside_a_group(monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    assert not dist.is_initialized()
    monkeypatch.setenv("QMLTPU_MESH", "2")
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="torchrun"):
        _pipeline.engine_kwargs()
    monkeypatch.setenv("QMLTPU_MESH", "1")
    assert "mesh" not in _pipeline.engine_kwargs()
    with pytest.raises(RuntimeError, match="torchrun"):
        mesh.make_mesh(2, device="cpu")
    assert not mesh.maybe_distributed_init("cpu")  # no torchrun environment
    with pytest.raises(ValueError, match="needs a mesh"):
        pgram.build_kernel_matrix_sharded(_ansatz(), _data()[0])


def test_cuda_mesh_without_a_card_raises(monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the machine without one")
    for key, value in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                           MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(key, value)
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.maybe_distributed_init("cuda")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="is_available"):
        mesh.make_mesh(device="cuda")
