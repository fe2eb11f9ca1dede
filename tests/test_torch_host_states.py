"""The large-chi memory path of the port's Gram build (``models/gram``):
chi-bucket slicing of each simulated batch, the residency rule
(``states_regime``, ``QMLTPU_STATES_DEVICE_BYTES``), host-resident states
with per-tile trimmed uploads and chunked norms, against the reference's
(``qml_cutensornet_tpu/models/gram.py``, ``tests/test_host_states.py``).

On the CPU the compute device is the host, so "host" and "device" differ
only in the code path; each regime is forced through the limit:

- the residency decision after every batch equals the reference's for the
  same batch shapes and limits (0, 1e12, limits at and between two
  projections, and a bucket sequence that grows so that the decision flips
  after the first batch), and so does the final residency of the assembled
  set (uploaded whole when it fits). Both packages run their own
  ``simulate_dataset`` on a stand-in simulator whose batches have the
  chosen chi buckets; the decision is read from the caller's frame when the
  next batch is simulated;
- the host-path Gram equals the device-path Gram to the bit (symmetric, and
  rectangular through the chunked norms), as the reference's test holds it;
- on states whose buckets differ (128 and 256), where host tiles are
  trimmed to their own bucket and device tiles run at the set's, the two
  paths agree within 1e-7 (f32): a trimmed tile runs its products at
  another shape, so the sums of the same terms may be grouped otherwise;
- the port's Gram is within the slice tests' bars of the reference's under
  the same limit (1e-10 in f64, 3e-5 in f32);
- ``_chi_bucket``'s rules equal the reference's."""

import sys
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qml_cutensornet_tpu.models.gram as ref_gram
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.ops.cpx import Cpx
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import gram
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph

CPU = torch.device("cpu")
NQ = 8


class _RefOut(NamedTuple):
    tensors: Cpx
    fidelity: jnp.ndarray
    bond_dims: jnp.ndarray


class _Out(NamedTuple):
    tensors: torch.Tensor
    fidelity: torch.Tensor
    bond_dims: torch.Tensor


def _stand_in(bonds, n_sites, padded, ref, seen):
    """A ``make_chunked_simulator`` whose i-th batch has tracked rank
    ``bonds[i]`` (zero states at ``padded`` chi); each call appends the
    caller's residency decision so far to ``seen``."""

    def make(*args, **kwargs):
        def sim(chunk):
            caller = sys._getframe(1).f_locals
            seen.append(caller["keep_device"] if ref else caller["regime"])
            b, bd = chunk.shape[0], bonds[len(seen) - 1]
            shape = (b, n_sites, padded, 2, padded)
            if ref:
                z = jnp.zeros(shape, jnp.float32)
                return _RefOut(Cpx(z, z), jnp.ones(b), jnp.full((b, n_sites - 1), bd, jnp.int32))
            return _Out(torch.zeros(shape, dtype=torch.complex64), torch.ones(b),
                        torch.full((b, n_sites - 1), bd, dtype=torch.int32))

        return sim

    return make


N_PTS, BATCH, SITES, PADDED = 10, 4, 2, 256  # 3 batches, the last one padded


def _projection(c):
    """The reference's projection for the stand-in's 3 batches at bucket ``c``."""
    return 2 * 3 * BATCH * SITES * c * 2 * c * 8


DECISIONS = [
    ("flat", [100, 100, 100], 0.0),
    ("flat", [100, 100, 100], 1e12),
    ("flat", [100, 100, 100], "at128"),
    ("flat", [100, 100, 100], "below128"),
    ("grows", [100, 200, 200], 0.0),
    ("grows", [100, 200, 200], 1e12),
    ("grows", [100, 200, 200], "between"),  # host after batch 1, assembled on the host
    ("grows", [100, 200, 200], "between_fits"),  # host after batch 1, then uploaded whole
    ("late", [100, 100, 200], "between"),
]


def _limit(kind):
    p128, p256 = _projection(128), _projection(256)
    return {"at128": p128, "below128": p128 - 1, "between": 0.35 * p256,
            "between_fits": 0.75 * p256}.get(kind, kind)


@pytest.mark.parametrize("name,bonds,limit", DECISIONS,
                         ids=[f"{n}-{lim}" for n, _, lim in DECISIONS])
def test_residency_decision_matches_reference(monkeypatch, name, bonds, limit):
    limit = _limit(limit)
    monkeypatch.setenv("QMLTPU_STATES_DEVICE_BYTES", repr(float(limit)))
    X = np.random.default_rng(0).uniform(0, 2, size=(N_PTS, SITES))
    ref_seen, seen = [], []
    monkeypatch.setattr(ref_gram, "make_chunked_simulator",
                        _stand_in(bonds, SITES, PADDED, True, ref_seen))
    monkeypatch.setattr(gram, "make_chunked_simulator",
                        _stand_in(bonds, SITES, PADDED, False, seen))
    ref_t, _, _, _ = ref_gram.simulate_dataset(None, X, RefConfig(), BATCH)
    t, _, _, _, regime = gram.simulate_dataset(None, X, SimConfig(), BATCH, CPU)
    # decisions after batches 1 and 2 (read when batches 2 and 3 start)
    ref_after = ["device" if k else "host" for k in ref_seen[1:]]
    assert seen[1:] == ref_after
    buckets = [gram._chi_bucket(b, PADDED) for b in bonds]
    want = [gram.states_regime(buckets[:i + 1], (BATCH, SITES), 3, 8, limit) for i in range(3)]
    assert ref_after == want[:2]
    # the assembled set: host-resident in both packages, or on the device in both
    assert regime == ("host" if isinstance(ref_t.re, np.ndarray) else "device")
    if want[-1] == "device":
        assert regime == "device"
    assert t.shape == ref_t.re.shape == (N_PTS, SITES, max(buckets), 2, max(buckets))
    if name == "grows" and limit == _limit("between"):
        assert want == ["device", "host", "host"] and regime == "host"


def test_states_regime_projection():
    # the reference's byte count: 2 copies x 3 batches x 4 states x [2, c, 2, c] complex64
    assert gram.states_regime([128], (4, 2), 3, 8, 2 * 3 * 4 * 2 * 128 * 2 * 128 * 8) == "device"
    assert gram.states_regime([128], (4, 2), 3, 8, 2 * 3 * 4 * 2 * 128 * 2 * 128 * 8 - 1) == "host"
    assert gram.states_regime([256, 128], (4, 2), 3, 4, _projection(256) / 2) == "device"


def _ansatz(nq=NQ):
    return (KernelStateAnsatz(nq, 2, 1.0, entanglement_graph(nq, 3)),
            RefAnsatz(nq, 2, 1.0, entanglement_graph(nq, 3)))


def _points(seed, n):
    return np.random.default_rng(seed).uniform(0, 2, size=(n, NQ))


def _port(monkeypatch, limit, X, Y=None, precision="f32", capsys=None):
    monkeypatch.setenv("QMLTPU_STATES_DEVICE_BYTES", limit)
    cfg = SimConfig(chi=256, truncation_error=1e-16, precision=precision, svd_method="subspace")
    K = gram.build_kernel_matrix(_ansatz()[0], X, Y, cfg=cfg, sim_batch=4, tile=4,
                                 device="cpu", loglevel=20 if capsys else 30)
    if capsys is not None:
        return K, capsys.readouterr().out
    return K


@pytest.mark.parametrize("rect", [False, True], ids=["symmetric", "rectangular"])
def test_host_path_equals_device_path(monkeypatch, capsys, rect):
    X = _points(3, 7)
    Y = _points(4, 3) if rect else None
    K_dev, out_dev = _port(monkeypatch, "1e12", X, Y, capsys=capsys)
    K_host, out_host = _port(monkeypatch, "0", X, Y, capsys=capsys)
    assert "States device-resident" in out_dev and "States host-resident" in out_host
    if rect:
        assert "(Y host-resident)" in out_host
    np.testing.assert_array_equal(K_dev, K_host)
    assert K_host.shape == ((3, 7) if rect else (7, 7))
    if not rect:
        assert np.abs(np.diag(K_host) - 1.0).max() < 1e-6


def _two_bucket_states(chunk):
    """Stand-in states of rank 100 (bucket 128) where ``x[0] < 1``, else 200
    (bucket 256), random inside the rank and exact zeros past it, each drawn
    from its own features."""
    b = chunk.shape[0]
    t = np.zeros((b, 3, 256, 2, 256), np.complex64)
    bonds = np.where(chunk[:, 0] < 1.0, 100, 200)
    for i in range(b):
        rng = np.random.default_rng(int(chunk[i, 1] * 1e6))
        r = bonds[i]
        t[i, :, :r, :, :r] = (rng.standard_normal((3, r, 2, r))
                              + 1j * rng.standard_normal((3, r, 2, r))) / r
    return _Out(torch.from_numpy(t), torch.ones(b, dtype=torch.float64),
                torch.from_numpy(np.repeat(bonds[:, None], 2, axis=1).astype(np.int32)))


@pytest.mark.parametrize("rect", [False, True], ids=["symmetric", "rectangular"])
def test_trimmed_host_tiles_match_device_tiles(monkeypatch, rect):
    """Tile (0, 0) of the host path runs at bucket 128, the rest at 256;
    the device path runs every tile at 256. The rectangular case's Y states
    all have bucket 128, below X's 256: each tile's bucket is capped by the
    wider set, so X blocks are not cut to Y's bucket."""
    monkeypatch.setattr(gram, "make_chunked_simulator", lambda *a, **k: _two_bucket_states)
    rng = np.random.default_rng(11)
    X = np.column_stack([np.r_[rng.uniform(0, 1, 4), rng.uniform(1, 2, 5)], rng.uniform(size=9)])
    Y = X[[0, 1, 2]] if rect else None
    ans = KernelStateAnsatz(3, 1, 1.0, entanglement_graph(3, 1))
    out = {}
    for limit in ("1e12", "0"):
        monkeypatch.setenv("QMLTPU_STATES_DEVICE_BYTES", limit)
        out[limit] = gram.build_kernel_matrix(ans, X, Y, cfg=SimConfig(chi=256), sim_batch=4,
                                              tile=4, device="cpu")
    np.testing.assert_allclose(out["0"], out["1e12"], atol=1e-7, rtol=0)
    assert np.isfinite(out["0"]).all() and out["0"].shape == ((3, 9) if rect else (9, 9))


@pytest.mark.parametrize("precision,tol,rect", [
    ("f32", 3e-5, False), ("f32", 3e-5, True), ("f64", 1e-10, False)])
def test_host_path_matches_reference(monkeypatch, precision, tol, rect):
    X = _points(5, 7)
    Y = _points(6, 3) if rect else None
    K = _port(monkeypatch, "0", X, Y, precision)
    rcfg = RefConfig(chi=256, truncation_error=1e-16, precision=precision,
                     svd_method="subspace")
    K_ref = ref_gram.build_kernel_matrix(_ansatz()[1], X, Y, cfg=rcfg, sim_batch=4, tile=4)
    np.testing.assert_allclose(K, K_ref, atol=tol, rtol=0)


def test_chi_bucket_rules():
    assert gram._chi_bucket(1, 64) == 64
    assert gram._chi_bucket(77, 96) == 96
    assert gram._chi_bucket(130, 512) == 192
    assert gram._chi_bucket(192, 256) == 192
    assert gram._chi_bucket(300, 512) == 320
    assert gram._chi_bucket(513, 1024) == 576
    assert gram._chi_bucket(1000, 1024) == 1024
    for padded in (16, 64, 128, 256, 512, 1024):
        for chi in range(1, padded + 1, 7):
            assert gram._chi_bucket(chi, padded) == ref_gram._chi_bucket(chi, padded)
