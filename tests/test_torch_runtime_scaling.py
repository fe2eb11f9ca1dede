"""The port's runtime_scaling suite (``qml_cutensornet_tpu_torch/runs/
runtime_scaling.py``) at a tiny size on the CPU, against the reference's
harness: ``run`` at nf 8, 2 and 4 points a class (and 2 once more on the
ring at world size 1, gloo) names its records as the reference's
``run_info`` with ``run_all.sh``'s ``_m1`` suffix, skips what exists, and its
CSV equals the text of the reference's pandas aggregation
(``runs/common.py``); ``ladder`` on ``cuda`` with fewer cards than ranks
raises. The ladder over gloo is ``tests/test_torch_runtime_ladder.py``."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from qml_cutensornet_tpu.utils.naming import run_info as ref_run_info
from qml_cutensornet_tpu_torch.cli import main_no_test
from qml_cutensornet_tpu_torch.runs import runtime_scaling

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("runs_common_reference", ROOT / "runs" / "common.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

SYN = "elliptic_preproc.csv"
TOL_RING_F32 = 3e-5
KNOBS = ("QMLTPU_CHI", "QMLTPU_SIM_BATCH", "QMLTPU_MESH", "NTRS", "RING_NTRS", "NF", "NDEVS",
         "NQ", "CHI")


@pytest.fixture
def runs_dir(tmp_path, monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("PREWARM", "0")
    return tmp_path / "runs" / "runtime_scaling"


def _refuse(*_a, **_k):
    raise AssertionError("a record that exists was simulated again")


def test_run_records_csv_and_plot(runs_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(runtime_scaling, "N_LABELED", 300)
    monkeypatch.setenv("NF", "8")
    monkeypatch.setenv("NTRS", "2 4")
    monkeypatch.setenv("RING_NTRS", "2")
    grams = runtime_scaling.run()
    base = {n: ref_run_info("train", 8, 2, 0.1, 1, n, 5, SYN) for n in (2, 4)}
    names = {f"{base[2]}_m1", f"{base[4]}_m1", f"{base[2]}_m1_ring"}
    assert set(grams) == names
    raw = runs_dir / "raw"
    assert {p.stem for p in raw.iterdir()} == names
    for name in names:
        assert json.loads((raw / f"{name}.json").read_text())["n_procs"] == [1, "devices"]
    # The ring at world size 1 builds the in-process Gram.
    np.testing.assert_allclose(grams[f"{base[2]}_m1_ring"], grams[f"{base[2]}_m1"],
                               atol=TOL_RING_F32)
    lines = [json.loads(x) for x in (runs_dir / "runs.jsonl").read_text().splitlines()]
    assert [x["raw"] for x in lines] == [f"{base[2]}_m1.json", f"{base[4]}_m1.json",
                                         f"{base[2]}_m1_ring.json"]
    assert all(x["data"].startswith("cli.make_synthetic 300") for x in lines)
    assert lines[-1]["mesh"] == 1 and lines[-1]["knobs"]["QMLTPU_MESH"] == "1"
    assert "QMLTPU_MESH" not in lines[0]["knobs"]

    # A second run simulates nothing.
    monkeypatch.setattr(main_no_test, "main", _refuse)
    assert runtime_scaling.run() == {}

    # The CSV is the reference's aggregation of the same records, as text.
    rows = runtime_scaling.csv()
    ref.runtime_scaling_csv(str(raw), str(tmp_path / "ref.csv"))
    assert (runs_dir / "results.csv").read_text() == (tmp_path / "ref.csv").read_text()
    assert sorted(r["data_set"] for r in rows) == [
        "elliptic_preproc_m1", "elliptic_preproc_m1", "elliptic_preproc_m1_ring"]
    runtime_scaling.plot()
    assert (runs_dir / "runtime_scaling.png").stat().st_size > 0


def test_ladder_on_cuda_needs_a_card_a_rank(runs_dir, monkeypatch):
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    monkeypatch.setenv("QMLTPU_DEVICE", "cuda")
    monkeypatch.setenv("NDEVS", f"1 {cards + 1}")
    with pytest.raises(RuntimeError, match="NCCL runs one rank a card"):
        runtime_scaling.ladder()
    assert not (runs_dir / runtime_scaling.LADDER_CSV).exists()
