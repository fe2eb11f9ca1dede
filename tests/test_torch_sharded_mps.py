"""The port's site-sharded brick engine (``parallel/sharded_mps``) on the CPU
over gloo, against the JAX package's ``parallel/sharded_mps`` on its
8-device virtual CPU mesh and against the port's whole-chain brick engine.

World sizes 2, 3 and 4 are one launch each (``mesh.launch``, one process a
rank, started at once), each making several calls (``dryrun.run_calls``);
world size 1 runs in this process, a mesh of one outside any process group.
The cases and bars are the reference's own (``tests/test_sharded_mps.py``),
inputs from numpy seeds:

- 10 qubits, r 2, d 2, chi 16, f32, subspace iters 1, 3 points of
  ``default_rng(7)``: the gathered MPS against the port's whole chain at
  the reference's bars between its two engines (bond dims equal, fidelity
  within rtol 1e-6, tensors within 2e-6), and against the reference's on
  ``make_mesh(4, "sp")`` on what no choice of basis changes (bond dims
  equal, fidelity within rtol 1e-5, normalized Gram within 1e-6; raw
  tensors differ by rotations of near-degenerate Schmidt vectors);
- 8 qubits, d 3, chi 16, f64, iters 2: tensors and Gram within 1e-12 of
  the whole chain, Gram within 1e-10 and fidelity within 1e-12 of the
  reference's;
- the fused configuration (K5 and K1's plain versions) against the
  reference's interpret-mode fused run: fidelity 1e-5, Gram within 3e-5;
- a 2-D ``(2, 2)`` mesh (two rows of two ranks, each row half the batch);
- the rank-0 halo write-back on parity-1 layers is bit-unchanged (a layer
  in this process, and rank 0's leading dummy site after a whole run);
- the relay on 7 points, tiles 3 to 5, against the tile scan of the whole
  chain's states (2e-6) and, normalized, the reference's
  ``sharded_tile_overlaps_sq`` (2e-6), and its symmetric mirror;
- ``sharded_gram`` against the reference's (5e-6, diagonal within 1e-6
  of 1);
- ``padded_sites_for`` and ``relay_auto_tile`` equal to the reference's;
- ``QMLTPU_SHARD_MPS`` through the CLI's ``engine_kwargs`` (the site mesh
  over the process group) and ``build_kernel_matrix`` against the whole
  chain (1e-6), its profiling JSON's ``n_procs`` the world size (the whole
  chain's 1)."""

import concurrent.futures
import json

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.models.entanglement import entanglement_graph as ref_graph
from qml_cutensornet_tpu.models.simulate import tile_overlaps_sq as ref_tiles
from qml_cutensornet_tpu.parallel import sharded_mps as ref_sm
from qml_cutensornet_tpu.parallel.mesh import make_mesh as ref_make_mesh
from qml_cutensornet_tpu_torch.cli import _pipeline
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix
from qml_cutensornet_tpu_torch.models.simulate import make_brick_simulator, tile_overlaps_sq
from qml_cutensornet_tpu_torch.parallel import dryrun, mesh, sharded_mps
from qml_cutensornet_tpu_torch.utils.device import environ

# name: (qubits, d, seed, points, config)
CASES = {
    "main": (10, 2, 7, 3, dict(precision="f32", subspace_iters=1)),
    "f64": (8, 3, 3, 4, dict(precision="f64", subspace_iters=2)),
    "fused": (10, 2, 17, 3, dict(precision="f32", subspace_iters=1, fused_split=True,
                                 fused_gate=True)),
    "two_d": (10, 3, 13, 4, dict(precision="f32", subspace_iters=1)),
    "relay": (10, 3, 21, 7, dict(precision="f32", subspace_iters=1)),
    "gram": (9, 2, 31, 6, dict(precision="f32", subspace_iters=1)),
    "knob": (10, 3, 9, 6, dict(precision="f32", subspace_iters=1)),
}
RELAY_TILE = {1: 4, 2: 3, 3: 5, 4: 4}  # relay tile at each world size
KNOB = {"QMLTPU_ROUTING": "brick", "QMLTPU_DEVICE": "cpu"}  # beside QMLTPU_SHARD_MPS
CALLS = ("main", "f64", "fused", "relay", "gram")  # the calls of every world size


def _case(name):
    nq, d, seed, npts, ckw = CASES[name]
    X = np.random.default_rng(seed).uniform(0, 2, size=(npts, nq))
    return nq, d, X, dict(chi=16, truncation_error=1e-16, svd_method="subspace", **ckw)


def _ansatz(name):
    nq, d, X, ckw = _case(name)
    return KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, d), routing="brick"), X, \
        SimConfig(**ckw)


def _calls(ws, work):
    """The port's calls on a world of ``ws`` ranks (``dryrun.run_calls``);
    the knob's build writes its profiling JSON into ``work``."""
    calls = []
    for name in ("main", "f64", "fused"):
        ans, X, cfg = _ansatz(name)
        calls.append((dryrun.simulate_site_sharded, (ans, X, cfg, "cpu"), {}, {}))
    ans, X, cfg = _ansatz("relay")
    calls.append((dryrun.relay_full_and_symmetric, (ans, X, cfg),
                  dict(mesh=dryrun.MESH, tile=RELAY_TILE[ws]), {}))
    ans, X, cfg = _ansatz("gram")
    calls.append((sharded_mps.sharded_gram, (ans, X, cfg), dict(mesh=dryrun.MESH, tile=4), {}))
    if ws == 4:
        ans, X, cfg = _ansatz("two_d")
        calls.append((dryrun.simulate_site_sharded, (ans, X, cfg, "cpu"), dict(dp=2), {}))
    if ws == 2:  # the knob's site mesh, then the Gram on the group's site mesh
        ans, X, cfg = _ansatz("knob")
        calls.append((_pipeline.engine_kwargs, (), {}, {**KNOB, "QMLTPU_SHARD_MPS": "2"}))
        calls.append((build_kernel_matrix, (ans, X),
                      dict(cfg=cfg, sim_batch=6, tile=6, device="cpu", site_mesh=dryrun.MESH,
                           info_file=str(work / "knob_ws2")), {}))
    return calls


def _in_process(work):
    """World size 1: the same calls in this process, on a mesh of one
    outside any process group; then the whole-chain engine's MPS of each
    case and Gram of the knob's case."""
    site = mesh.make_site_mesh(device="cpu")
    out = []
    for fn, args, kwargs, env in _calls(1, work):
        kwargs = {k: (site if v == dryrun.MESH else v) for k, v in kwargs.items()}
        with environ(**env):
            out.append(fn(*args, **kwargs))
    ans, X, cfg = _ansatz("knob")
    with environ(**KNOB, QMLTPU_SHARD_MPS="all"):
        kw = _pipeline.engine_kwargs()
    out += [kw, build_kernel_matrix(ans, X, cfg=cfg, sim_batch=6, tile=6, device="cpu",
                                    site_mesh=kw["site_mesh"], info_file=str(work / "knob_ws1"))]
    whole = {"knob": build_kernel_matrix(ans, X, cfg=cfg, sim_batch=6, tile=6, device="cpu",
                                         info_file=str(work / "knob_whole"))}
    for name in ("main", "f64", "fused", "two_d", "relay"):
        ans, X, cfg = _ansatz(name)
        whole[name] = make_brick_simulator(ans.schedule, cfg, torch.device("cpu"))(X)
    return out, whole


def _reference():
    """The reference's sharded engine on its virtual CPU mesh (4 devices,
    and a (2, 2) mesh for the 2-D case): fidelities, bond dims and
    normalized Grams of its states, and its relays."""
    import jax
    from jax.sharding import Mesh

    assert len(jax.devices()) == 8
    m4 = ref_make_mesh(4, axis="sp")

    def ref_case(name):
        nq, d, X, ckw = _case(name)
        if ckw.get("fused_gate"):
            ckw = dict(ckw, fused_interpret=True)
        ans = RefAnsatz(nq, 2, 1.0, ref_graph(nq, d), routing="brick")
        return ans, X, RefConfig(**ckw)

    def summary(st):
        k = np.asarray(ref_tiles(st.tensors, st.tensors))
        dg = np.sqrt(np.diag(k))
        return np.asarray(st.fidelity), np.asarray(st.bond_dims), k / np.outer(dg, dg)

    out = {}
    for name in ("main", "f64", "fused"):
        ans, X, cfg = ref_case(name)
        out[name] = summary(ref_sm.make_sharded_brick_simulator(ans.schedule, cfg, m4)(X))
    ans, X, cfg = ref_case("two_d")
    m22 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "sp"))
    out["two_d"] = summary(ref_sm.make_sharded_brick_simulator(ans.schedule, cfg, m22)(X))
    ans, X, cfg = ref_case("relay")
    st = ref_sm.make_sharded_brick_simulator(ans.schedule, cfg, m4, gather=False)(X)
    for tile in (3, 4, 5):
        out[("relay", tile)] = np.asarray(
            ref_sm.sharded_tile_overlaps_sq(st.tensors, st.tensors, m4, tile=tile))
    ans, X, cfg = ref_case("gram")
    out["gram"] = ref_sm.sharded_gram(ans, X, cfg, m4, tile=4)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Port results by world size (each a list in ``_calls`` order; rank
    0's), the whole chain's and the reference's, and the directory of the
    knob's profiling JSONs; the three launches (one thread a rank) run while
    the reference and world size 1 compute here."""
    work = tmp_path_factory.mktemp("sharded_mps")
    with environ(OMP_NUM_THREADS="1"), concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {ws: pool.submit(mesh.launch, dryrun.run_calls, ws, "cpu", "cpu",
                                   _calls(ws, work))
                   for ws in (2, 3, 4)}
        out = {"ref": _reference(), "work": work}
        out[1], out["whole"] = _in_process(work)
        for ws, f in futures.items():
            out[ws] = [r["out"] for r in f.result()]
    return out


def _kernel(tensors):
    k = tile_overlaps_sq(tensors, tensors).numpy()
    dg = np.sqrt(np.diag(k))
    return k / np.outer(dg, dg)


def _check(st, whole, ref, tol, fid_rtol, ref_fid_rtol, ref_gram_tol):
    """A gathered site-sharded MPS against the port's whole chain with the
    reference's bars between its own two engines (bond dims equal, fidelity
    within ``fid_rtol``, tensors within ``tol``), and against the reference's
    site-sharded run on what no choice of basis changes (bond dims,
    fidelity, the normalized Gram): the two packages' factorizations sum in
    other orders, so near-degenerate Schmidt vectors come out rotated."""
    tensors = st.tensors.numpy()
    assert tensors.shape == whole.tensors.shape
    np.testing.assert_array_equal(st.bond_dims.numpy(), whole.bond_dims.numpy())
    np.testing.assert_allclose(st.fidelity.numpy(), whole.fidelity.numpy(), rtol=fid_rtol)
    assert np.abs(tensors - whole.tensors.numpy()).max() <= tol
    ref_fid, ref_bd, ref_k = ref
    np.testing.assert_array_equal(st.bond_dims.numpy(), ref_bd)
    np.testing.assert_allclose(st.fidelity.numpy(), ref_fid, rtol=ref_fid_rtol)
    np.testing.assert_allclose(_kernel(st.tensors), ref_k, atol=ref_gram_tol, rtol=0)


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_sharded_matches_reference_and_whole_chain(runs, ws):
    st, _ = runs[ws][CALLS.index("main")]
    _check(st, runs["whole"]["main"], runs["ref"]["main"], 2e-6, 1e-6, 1e-5, 1e-6)


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_sharded_f64_exact(runs, ws):
    st, _ = runs[ws][CALLS.index("f64")]
    _check(st, runs["whole"]["f64"], runs["ref"]["f64"], 1e-12, 1e-12, 1e-12, 1e-10)
    np.testing.assert_allclose(_kernel(st.tensors), _kernel(runs["whole"]["f64"].tensors),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_sharded_fused_matches_reference_interpret(runs, ws):
    """K5 and K1's plain versions against the reference's Pallas kernels in
    interpret mode, at the reference's fused-vs-plain bars (fidelity 1e-5,
    Gram 3e-5)."""
    st, _ = runs[ws][CALLS.index("fused")]
    _check(st, runs["whole"]["fused"], runs["ref"]["fused"], 2e-6, 1e-6, 1e-5, 3e-5)


def test_two_d_mesh(runs):
    st, _ = runs[4][len(CALLS)]
    assert st.tensors.shape[0] == 4  # both rows' halves of the batch
    _check(st, runs["whole"]["two_d"], runs["ref"]["two_d"], 2e-6, 1e-6, 1e-5, 1e-6)


def test_halo_write_back_is_bit_unchanged(runs):
    """Parity 1: the wrap pair (the last rank's straddler) is inactive, so
    the halo returned to rank 0 is its own first site, to the bit. Checked
    on one layer of random states here (a mesh of one: the halo is the
    rank's own first site), and after whole runs at every world size: rank
    0's leading dummy site is still exactly ``e0 (x) |0> (x) e0``."""
    rng = np.random.default_rng(5)
    B, n_loc, chi = 2, 6, 4
    z = rng.normal(size=(B, n_loc, chi, 2, chi)) + 1j * rng.normal(size=(B, n_loc, chi, 2, chi))
    state = sharded_mps.ShardedVidalState(
        tensors=torch.from_numpy(z), lams=torch.from_numpy(rng.uniform(size=(B, n_loc, chi))),
        fidelity=torch.ones(B, dtype=torch.float64),
        bond_dims=torch.full((B, n_loc), chi, dtype=torch.int32))
    first = state.tensors[:, 0].clone()
    act = torch.tensor([True] * (n_loc // 2 - 1) + [False])  # the wrap pair last, inactive
    th = torch.from_numpy(rng.uniform(size=(B, n_loc // 2)))
    cfg = SimConfig(chi=chi, truncation_error=1e-16, precision="f64", svd_method="subspace")
    out = sharded_mps._layer_local(state, 1, 1.0, act, th, cfg, mesh.make_site_mesh(device="cpu"))
    assert torch.equal(out.tensors[:, 0], first)
    assert not torch.equal(out.tensors[:, 1], torch.from_numpy(z[:, 1]))  # pairs did update
    dummy = torch.zeros((16, 2, 16), dtype=torch.complex64)
    dummy[0, 0, 0] = 1.0
    for ws in (1, 2, 3, 4):
        site0 = runs[ws][CALLS.index("relay")]["first_site"]
        assert all(torch.equal(s, dummy) for s in site0), ws


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_relay_matches_reference(runs, ws):
    """The relay against the single-device tile scan of the whole chain's
    states (the reference's own relay bar, 2e-6) and, normalized by their
    diagonals, against the reference's relay (2e-6): raw overlaps carry
    each package's own f32 norm deficits of truncation (1e-5 here)."""
    rec = runs[ws][CALLS.index("relay")]
    full, sym = rec["full"], rec["sym"]
    assert full.shape == sym.shape == (7, 7)
    whole = runs["whole"]["relay"].tensors
    np.testing.assert_allclose(full, tile_overlaps_sq(whole, whole).numpy(), atol=2e-6, rtol=0)

    def normalized(k):
        dg = np.sqrt(np.diag(k))
        return k / np.outer(dg, dg)

    np.testing.assert_allclose(normalized(full),
                               normalized(runs["ref"][("relay", RELAY_TILE[ws])]),
                               atol=2e-6, rtol=0)
    t = RELAY_TILE[ws]
    # mirrored off-diagonal blocks are exact transposes (copied, not recomputed)
    np.testing.assert_array_equal(sym[t:2 * t, :t], sym[:t, t:2 * t].T)
    np.testing.assert_allclose(sym, sym.T, atol=1e-6)
    np.testing.assert_allclose(sym, full, atol=2e-6)


@pytest.mark.parametrize("ws", [1, 2, 3, 4])
def test_sharded_gram_matches_reference(runs, ws):
    k = runs[ws][CALLS.index("gram")]
    assert k.shape == (6, 6)
    np.testing.assert_allclose(k, runs["ref"]["gram"], atol=5e-6)
    assert np.abs(np.diag(k) - 1).max() < 1e-6


@pytest.mark.parametrize("ws", [1, 2])
def test_knob_through_build_kernel_matrix(runs, ws):
    """The CLI's ``engine_kwargs`` under ``QMLTPU_SHARD_MPS`` ("all" outside
    a group, N in a group of N) gives the site mesh over the process group
    and no ring; ``build_kernel_matrix`` on it equals the whole chain."""
    kw, k = runs[ws][-2:]
    assert "mesh" not in kw and kw["site_mesh"].size == ws and kw["site_mesh"].dp == 1
    np.testing.assert_allclose(k, runs["whole"]["knob"], atol=1e-6)


@pytest.mark.parametrize("name,n_procs", [("knob_ws1", 1), ("knob_ws2", 2), ("knob_whole", 1)])
def test_profile_reports_site_mesh_ranks(runs, name, n_procs):
    """A site-sharded build's profiling JSON counts its site mesh's ranks,
    as the reference's counts its devices; a whole-chain build one."""
    prof = json.loads((runs["work"] / f"{name}.json").read_text())
    assert prof["n_procs"] == [n_procs, "devices"]


def test_padded_sites_and_relay_tile_equal_reference(monkeypatch):
    for ndev in (1, 2, 3, 4, 8):
        for n_p in (9, 11, 13, 103):
            n_s = sharded_mps.padded_sites_for(n_p, ndev)
            assert n_s == ref_sm.padded_sites_for(n_p, ndev)
            assert n_s > n_p and n_s % (2 * ndev) == 0
    for budget in (None, str(1 << 26)):
        if budget is not None:
            monkeypatch.setenv("QMLTPU_RELAY_TILE_BYTES", budget)
        for chi in (8, 16, 128, 512, 2048):
            for n_loc in (2, 13, 104):
                assert (sharded_mps.relay_auto_tile(chi, n_loc)
                        == ref_sm.relay_auto_tile(chi, n_loc)), (budget, chi, n_loc)
