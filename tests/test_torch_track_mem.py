"""``cli.main_track_mem`` and the synthetic dataset of the port against the
JAX reference on the CPU.

- the op-by-op memory log (``[DEBUG] MPS size (MiB) = <x>`` after every op
  of the schedule, the line ``runs/mem_evol/plot.py`` parses) at nq 4 to 6
  in f64: the same number of lines as the reference's, values to 1e-9, and
  the final fidelity and max bond; then the CLI of each package end to end;
- ``utils/data.make_synthetic_elliptic`` and ``cli.make_synthetic``: the
  raw and preprocessed CSVs parse to the reference's arrays, and the
  ``.provenance.json`` rule (a matching call does nothing, a mismatched one
  raises unless forced). Everything is written into a temporary directory."""

import io
import pathlib

import numpy as np
import pandas as pd
import pytest

from qml_cutensornet_tpu.cli import main_track_mem as ref_track
from qml_cutensornet_tpu.cli import make_synthetic as ref_make_synthetic
from qml_cutensornet_tpu.config import SimConfig as RefConfig
from qml_cutensornet_tpu.models.ansatz import KernelStateAnsatz as RefAnsatz
from qml_cutensornet_tpu.utils import data as ref_data
from qml_cutensornet_tpu_torch.cli import main_track_mem, make_synthetic
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.ops import mps
from qml_cutensornet_tpu_torch.utils import data

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sizes(text):
    lines = [line for line in text.splitlines() if "MPS size" in line]
    return np.array([float(line.split("=")[1]) for line in lines])


@pytest.mark.parametrize("nq,d", [(4, 1), (5, 2), (6, 3)])
def test_mem_log_matches_reference(nq, d):
    x = np.random.default_rng(nq).uniform(0.0, 2.0, size=nq)
    em = entanglement_graph(nq, d)
    ref_log, log = io.StringIO(), io.StringIO()
    ref_state = ref_track.simulate_with_mem_log(RefAnsatz(nq, 2, 1.0, em).schedule, x,
                                                RefConfig(chi=8, precision="f64"), log=ref_log)
    schedule = KernelStateAnsatz(nq, 2, 1.0, em).schedule
    state = main_track_mem.simulate_with_mem_log(schedule, x, SimConfig(chi=8, precision="f64"),
                                                 device="cpu", log=log)
    got, want = _sizes(log.getvalue()), _sizes(ref_log.getvalue())
    assert len(got) == len(want) == schedule.num_two_site_ops
    np.testing.assert_allclose(got, want, atol=1e-9)
    assert (got > 0).all()
    assert abs(float(state.fidelity[0]) - float(ref_state.fidelity)) <= 1e-9
    assert int(mps.max_bond(state)[0]) == int(ref_state.bond_dims.max())


def test_cli_matches_reference(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_PRECISION", "f64")
    (tmp_path / "datasets").mkdir()
    data.preprocess_elliptic(str(ROOT / "datasets/elliptic_bitcoin_dataset_v1"), "datasets/v1.csv")
    argv = ["main_track_mem", "GPU", "6", "2", "1.0", "2", "5", "5", "1", "v1.csv", "3"]
    main_track_mem.main(argv)
    port = capsys.readouterr()
    ref_track.main(argv)
    ref = capsys.readouterr()
    got, want = _sizes(port.err), _sizes(ref.err)
    assert len(got) == len(want) > 0
    np.testing.assert_allclose(got, want, atol=1e-9)
    for key in ("Final fidelity:", "Max bond dimension:"):
        g = [line for line in port.out.splitlines() if line.startswith(key)]
        w = [line for line in ref.out.splitlines() if line.startswith(key)]
        assert len(g) == len(w) == 1
        assert abs(float(g[0].split(":")[1]) - float(w[0].split(":")[1])) <= 1e-9
    with pytest.raises(ValueError, match="circ_index"):
        main_track_mem.main(argv[:-1])


def _raw_arrays(dataset_dir):
    feats = np.loadtxt(f"{dataset_dir}/elliptic_txs_features.csv", delimiter=",")
    classes = pd.read_csv(f"{dataset_dir}/elliptic_txs_classes.csv", header=None, dtype=str)
    return feats, classes.to_numpy()


def test_synthetic_dataset_matches_reference(tmp_path):
    kw = dict(n_labeled=300, n_unknown=60, seed=3)
    data.make_synthetic_elliptic(str(tmp_path / "port"), **kw)
    ref_data.make_synthetic_elliptic(str(tmp_path / "ref"), **kw)
    pf, pc = _raw_arrays(tmp_path / "port")
    rf, rc = _raw_arrays(tmp_path / "ref")
    assert pf.shape == (360, 2 + 165)
    np.testing.assert_array_equal(pf, rf)
    np.testing.assert_array_equal(pc, rc)
    assert (tmp_path / "port/.provenance.json").read_text() == \
        (tmp_path / "ref/.provenance.json").read_text()
    # the provenance rule: a matching call is a no-op, a mismatched one
    # raises unless forced
    raw = tmp_path / "port/elliptic_txs_features.csv"
    raw.write_text("sentinel\n")
    data.make_synthetic_elliptic(str(tmp_path / "port"), **kw)
    assert raw.read_text() == "sentinel\n"
    with pytest.raises(RuntimeError, match="refusing to overwrite"):
        data.make_synthetic_elliptic(str(tmp_path / "port"), **{**kw, "seed": 4})
    assert raw.read_text() == "sentinel\n"
    data.make_synthetic_elliptic(str(tmp_path / "port"), force=True, **{**kw, "seed": 4})
    assert _raw_arrays(tmp_path / "port")[0].shape == (360, 2 + 165)


def test_cli_make_synthetic_matches_reference(tmp_path, monkeypatch, capsys):
    outs = {}
    for name, entry in (("port", make_synthetic), ("ref", ref_make_synthetic)):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        entry.main(["make_synthetic", "200", "5"])
        outs[name] = capsys.readouterr().out
    assert outs["port"] == outs["ref"]
    port = data.read_preprocessed(str(tmp_path / "port/datasets/elliptic_preproc.csv"))
    ref = data.read_preprocessed(str(tmp_path / "ref/datasets/elliptic_preproc.csv"))
    np.testing.assert_array_equal(port, ref)
    np.testing.assert_array_equal(
        port, pd.read_csv(tmp_path / "ref/datasets/elliptic_preproc.csv").to_numpy())
