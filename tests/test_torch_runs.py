"""The port's experiment harness (``qml_cutensornet_tpu_torch/runs``) against
the reference's ``runs/common.py``: every CSV the port writes equals, header
and text, what the reference's pandas aggregation writes from the same raw
files (synthetic profiles and metric dumps, and the records the port's
suites write at a tiny size on the CPU); the suites name their records as
the reference's ``run_info`` does, skip what exists, restore the caller's
environment, refuse to run without the pinned v1 data, and import neither
pandas, JAX nor the reference."""

import importlib.util
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

from qml_cutensornet_tpu.utils.naming import run_info as ref_run_info
from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.cli import main_no_test
from qml_cutensornet_tpu_torch.runs import (_harness, common, crossover, mem_evol, qml_figures,
                                            qubit_scaling, table2, table3)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("runs_common_reference", ROOT / "runs" / "common.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

V1 = "elliptic_preproc_bench.csv"
SUITES = ("qubit_scaling", "mem_evol", "crossover", "table2", "table3", "qml_figures",
          "runtime_scaling")
KNOBS = ("QMLTPU_CHI", "QMLTPU_SIM_BATCH", "QMLTPU_ROUTING", "QMLTPU_FUSED_GATE",
         "QMLTPU_OVERSAMPLE", "NFS", "NF", "GAMMAS", "NTR", "NTRS", "D", "DS", "XS", "SEEDS",
         "RS", "PREWARM")


@pytest.fixture
def runs_dir(tmp_path, monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("QMLTPU_DEVICE", "cpu")
    monkeypatch.setenv("QMLTPU_RUNS_DIR", str(tmp_path / "runs"))
    monkeypatch.setenv("PREWARM", "0")
    return tmp_path / "runs"


def _same_csv(port_fn, ref_fn, args, tmp_path):
    """Both aggregations of the same raw files: the same text."""
    port_csv, ref_csv = tmp_path / "port.csv", tmp_path / "ref.csv"
    port_rows = port_fn(*args, str(port_csv))
    ref_fn(*args, str(ref_csv))
    assert port_csv.read_text() == ref_csv.read_text()
    return port_rows


# -- the CSV functions against the reference, on synthetic raw files --------

def _profile(rng, int_chi=False, int_mem=False):
    f = lambda: float(rng.uniform(0.0, 50.0))  # noqa: E731
    chi = (int(rng.integers(2, 200)) if int_chi else f())
    prof = {"n_procs": [int(rng.integers(1, 5)), "devices"], "lenX": [8, "entries"],
            "lenY": [None, "entries"], "r0_circ_sim": [f(), "seconds"],
            "avg_circ_sim": [f(), "seconds"], "median_circ_sim": [f(), "seconds"],
            "q1_circ_sim": [f(), "seconds"], "q3_circ_sim": [f(), "seconds"],
            "avg_mps_mem": [int(rng.integers(1, 9)) if int_mem else f(), "MiB"],
            "ave max chi x": [chi, "chi x"], "ave max chi y": [chi, "chi y"],
            "r0_RR_recv": [0.0, "seconds"], "kernel_mat_time": [f(), "seconds"],
            "total_time": [f(), "seconds"], "r0_product": [f(), "seconds"],
            "avg_product": [f() / 1e4, "seconds"], "median_product": [f() / 1e4, "seconds"],
            "q1_product": [f() / 1e5, "seconds"], "q3_product": [f() / 1e3, "seconds"]}
    return prof


def _profiles(d, names, rng):
    d.mkdir(parents=True)
    for i, name in enumerate(names):
        (d / f"{name}.json").write_text(json.dumps(_profile(rng, i % 2 == 0, i == 1)))


def _metrics(rng, n_reg=6):
    """[C, accuracy, precision, recall, auc] rows, AUCs on a grid of 1/8 so
    that equal maxima occur (the first one wins)."""
    regs = [0.01, 0.1, 0.5, 1.0, 2.0, 4.0][:n_reg]
    return np.array([[c, *rng.uniform(0.4, 1.0, 3), rng.integers(4, 9) / 8] for c in regs])


PROFILE_CASES = {
    "runtime_scaling": [ref_run_info("train", 165, 2, 0.1, 1, n, 5, "elliptic_preproc.csv")
                        for n in (200, 400, 800)],
    "qubit_scaling": [ref_run_info("train", nf, 2, g, 6, 5, 5, V1)
                      for nf in (30, 60, 165) for g in (0.1, 0.5, 1.0)],
    "crossover": [ref_run_info("train", 100, 2, 1.0, d, 5, 5, V1) + sfx
                  for d, sfx in ((2, ""), (6, ""), (6, "_brick_chi128"), (10, ""),
                                 (12, "_tracked_chi1024"))],
}


@pytest.mark.parametrize("case", ["runtime_scaling", "qubit_scaling", "crossover_gpu",
                                  "crossover_cpu"])
def test_profile_csvs_equal_reference(case, tmp_path):
    raw = tmp_path / "raw"
    _profiles(raw, PROFILE_CASES[case.split("_")[0] if "crossover" in case else case],
              np.random.default_rng(len(case)))
    if case.startswith("crossover"):
        with_mem = case == "crossover_gpu"
        rows = _same_csv(lambda r, o: common.crossover_csv(r, o, with_mem=with_mem),
                         lambda r, o: ref.crossover_csv(r, o, with_mem=with_mem), [str(raw)],
                         tmp_path)
        assert sorted({r["config"] for r in rows}) == [
            "elliptic_preproc_bench", "elliptic_preproc_bench_brick_chi128",
            "elliptic_preproc_bench_tracked_chi1024"]
    else:
        rows = _same_csv(getattr(common, f"{case}_csv"), getattr(ref, f"{case}_csv"),
                         [str(raw)], tmp_path)
    assert len(rows) == len(list(raw.iterdir()))


def test_table_csvs_equal_reference(tmp_path):
    rng = np.random.default_rng(7)
    quantum, gaussian, depth = tmp_path / "quantum", tmp_path / "gaussian", tmp_path / "depth"
    for p in (quantum, gaussian, depth):
        p.mkdir()
    for s in (5, 8, 20):
        np.save(gaussian / f"seed_{s}.npy", _metrics(rng))
        for d in (1, 2, 4):
            for g in (0.1, 0.5, 1.0):
                for kind in ("train", "test"):
                    np.save(quantum / f"{ref_run_info(kind, 50, 2, g, d, 200, s, 'x.csv')}.npy",
                            _metrics(rng))
        for r in (2, 4, 8, 20):
            np.save(depth / f"{ref_run_info('test', 50, r, 1.0, 1, 200, s, 'x.csv')}.npy",
                    _metrics(rng))
    rows = _same_csv(common.table2_csv, ref.table2_csv, [str(quantum), str(gaussian)], tmp_path)
    assert [r["kernel"] for r in rows] == ["Gaussian"] + ["Quantum"] * 9
    rows = _same_csv(common.table3_csv, ref.table3_csv, [str(depth)], tmp_path)
    assert [r["depth"] for r in rows] == [2, 4, 8, 20]


def test_best_by_auc_takes_the_first_maximum():
    best = common._best_by_auc({"auc": [[0.5], [0.9], [0.9]], "recall": [[1.0], [2.0], [3.0]]})
    assert best == ref._best_by_auc({"auc": [[0.5], [0.9], [0.9]],
                                     "recall": [[1.0], [2.0], [3.0]]})
    assert best["recall"] == 2.0


def test_runs_modules_import_without_pandas_jax_or_reference():
    code = (
        "import importlib, sys\n"
        "for name in ('pandas', 'jax', 'jaxlib', 'qml_cutensornet_tpu', 'sklearn'):\n"
        "    sys.modules[name] = None\n"
        f"for suite in {SUITES + ('common', '_harness')!r}:\n"
        "    importlib.import_module('qml_cutensornet_tpu_torch.runs.' + suite)\n"
        "from qml_cutensornet_tpu_torch.cli import main, main_no_test, main_track_mem\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# -- the suites at a tiny size on the CPU -------------------------------------

def _runs_lines(runs_dir, suite):
    path = runs_dir / suite / "runs.jsonl"
    return [json.loads(x) for x in path.read_text().splitlines()] if path.exists() else []


def _refuse(*_a, **_k):
    raise AssertionError("a record that exists was simulated again")


def test_qubit_scaling_suite(runs_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("NFS", "4")
    monkeypatch.setenv("GAMMAS", "0.5 1.0")
    monkeypatch.setenv("NTR", "2")
    monkeypatch.setenv("D", "1")
    monkeypatch.setenv("PREWARM", "1")
    grams = qubit_scaling.run()
    assert "QMLTPU_CHI" not in os.environ and "QMLTPU_SIM_BATCH" not in os.environ
    raw = runs_dir / "qubit_scaling" / "raw"
    names = {ref_run_info("train", 4, 2, g, 1, 2, 5, V1) for g in (0.5, 1.0)}
    assert set(grams) == names
    assert {p.stem for p in raw.iterdir()} == names  # the prewarm's record is gone
    lines = _runs_lines(runs_dir, "qubit_scaling")
    assert [bool(x.get("prewarm")) for x in lines] == [True, False, False]
    assert all(x["knobs"]["QMLTPU_CHI"] == "64" and x["knobs"]["QMLTPU_SIM_BATCH"] == "10"
               for x in lines)

    # The record equals a direct CLI call at the suite's knobs.
    ri = ref_run_info("train", 4, 2, 1.0, 1, 2, 5, V1)
    monkeypatch.chdir(runs_dir / "qubit_scaling" / "work")
    monkeypatch.setenv("QMLTPU_CHI", "64")
    monkeypatch.setenv("QMLTPU_SIM_BATCH", "10")
    K = main_no_test.main(["main_no_test.py", "GPU", "4", "2", "1.0", "1", "2", "2", "5", V1])
    np.testing.assert_array_equal(K, grams[ri])
    direct = json.loads(pathlib.Path(f"{ri}.json").read_text())
    kept = json.loads((raw / f"{ri}.json").read_text())
    assert direct["ave max chi x"] == kept["ave max chi x"]
    assert kept["chi"][0] == 64

    # A second run simulates nothing; a caller's cap is used and kept.
    monkeypatch.setattr(main_no_test, "main", _refuse)
    monkeypatch.setenv("QMLTPU_CHI", "8")
    assert qubit_scaling.run() == {}
    assert os.environ["QMLTPU_CHI"] == "8" and os.environ["QMLTPU_SIM_BATCH"] == "10"
    assert len(_runs_lines(runs_dir, "qubit_scaling")) == 3

    rows = _same_csv(common.qubit_scaling_csv, ref.qubit_scaling_csv, [str(raw)], tmp_path)
    assert [r["avg_max_chi"] for r in rows] == [
        json.loads((raw / f"{n}.json").read_text())["ave max chi x"][0] for n in sorted(names)]
    qubit_scaling.csv()
    qubit_scaling.plot()
    assert (runs_dir / "qubit_scaling" / "qubit_scaling.png").stat().st_size > 0


def test_crossover_suite(runs_dir, monkeypatch, tmp_path):
    monkeypatch.setenv("NF", "4")
    monkeypatch.setenv("DS", "1")
    # A relative QMLTPU_RUNS_DIR is taken from the caller's directory, not
    # from the suites' working directory.
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("QMLTPU_RUNS_DIR", "runs")
    grams = crossover.run("cpu", "gpu", "brick")
    assert os.environ["QMLTPU_RUNS_DIR"] == "runs" and pathlib.Path.cwd() == tmp_path
    for k in ("QMLTPU_CHI", "QMLTPU_ROUTING", "QMLTPU_FUSED_GATE", "QMLTPU_OVERSAMPLE",
              "QMLTPU_SIM_BATCH"):
        assert k not in os.environ, k
    ri = ref_run_info("train", 4, 2, 1.0, 1, 5, 5, V1)
    assert set(grams) == {f"cpu/{ri}", f"gpu/{ri}", f"brick/{ri}_brick_chi128"}
    raw = runs_dir / "crossover" / "raw"
    assert sorted(p.name for p in (raw / "gpu").iterdir()) == [f"{ri}.json",
                                                              f"{ri}_brick_chi128.json"]
    lines = {x["mode"]: x for x in _runs_lines(runs_dir, "crossover")}
    assert lines["cpu"]["criterion"] == "cutoff" and lines["gpu"]["criterion"] == "fidelity"
    assert lines["cpu"]["argv"][0] == "CPU" and lines["cpu"]["knobs"]["QMLTPU_DEVICE"] == "cpu"
    assert lines["brick"]["knobs"]["QMLTPU_ROUTING"] == "brick"
    assert lines["brick"]["knobs"]["QMLTPU_CHI"] == "128"
    assert all(x["launches"] == dict.fromkeys(x["launches"], 0) for x in lines.values())
    for K in grams.values():
        np.testing.assert_allclose(np.diag(K), 1.0, atol=1e-12)
        np.testing.assert_allclose(K, K.T, atol=1e-6)
    monkeypatch.setattr(main_no_test, "main", _refuse)
    assert crossover.run("cpu", "gpu", "brick") == {}
    rows = _same_csv(lambda r, o: common.crossover_csv(r, o, with_mem=True),
                     lambda r, o: ref.crossover_csv(r, o, with_mem=True), [str(raw / "gpu")],
                     tmp_path)
    assert [r["config"] for r in rows] == ["elliptic_preproc_bench",
                                           "elliptic_preproc_bench_brick_chi128"]
    _same_csv(lambda r, o: common.crossover_csv(r, o, with_mem=False),
              lambda r, o: ref.crossover_csv(r, o, with_mem=False), [str(raw / "cpu")], tmp_path)


@pytest.mark.parametrize("d, chi, mode, suffix", [
    (2, 64, "gpu", ""), (10, 512, "cpu", ""), (12, 1024, "gpu", "_tracked_chi1024"),
    (12, 512, "gpu", "_tracked_chi512"), (6, 128, "brick", "_brick_chi128")])
def test_crossover_names_other_configurations(d, chi, mode, suffix):
    assert crossover.config_suffix(mode, d, chi) == suffix
    assert crossover.chi_for_d(d) == {2: 64, 6: 192, 10: 512, 12: 1024}[d]


def test_mem_evol_captures_parse_by_reference(runs_dir, monkeypatch):
    monkeypatch.setenv("NF", "4")
    monkeypatch.setenv("DS", "1 2")
    monkeypatch.setenv("XS", "0 1")
    wrote = mem_evol.run()
    assert set(wrote) == {"d1/0.out", "d1/1.out", "d2/0.out", "d2/1.out"}
    for d in (1, 2):
        raw = runs_dir / "mem_evol" / "raw" / f"d{d}"
        series = ref.mem_evol_series(str(raw))
        assert series == common.mem_evol_series(str(raw))
        params = pipe.parse_argv(["x", "GPU", "4", "2", "1.0", str(d), "5", "5", "5", V1])
        n_ops = pipe.make_ansatz(params).schedule.num_two_site_ops
        assert sorted(series) == ["0.out", "1.out"]
        assert all(len(v) == n_ops and min(v) > 0 for v in series.values())
    monkeypatch.setattr("qml_cutensornet_tpu_torch.cli.main_track_mem.main", _refuse)
    assert mem_evol.run() == {}
    mem_evol.plot()
    assert (runs_dir / "mem_evol" / "mem_evol.png").stat().st_size > 0


def test_table_suites_feed_the_reference_aggregation(runs_dir, monkeypatch, tmp_path):
    # 4 + 4 points: the test split then holds both classes, which the AUC needs.
    monkeypatch.setenv("NF", "4")
    monkeypatch.setenv("NTR", "4")
    monkeypatch.setenv("SEEDS", "5")
    monkeypatch.setenv("RS", "1 2")
    wrote = table3.run()
    assert wrote == [ref_run_info("test", 4, r, 1.0, 1, 4, 5, "elliptic_preproc.csv")
                     for r in (1, 2)]
    raw3 = runs_dir / "table3" / "raw"
    assert len(list(raw3.glob("train_*.npy"))) == len(list(raw3.glob("test_*.npy"))) == 2
    rows = _same_csv(common.table3_csv, ref.table3_csv, [str(raw3)], tmp_path)
    assert [r["depth"] for r in rows] == [1, 2]

    # table2 on the same synthetic data (copied, not generated again)
    shutil.copytree(runs_dir / "table3" / "work" / "datasets",
                    runs_dir / "table2" / "work" / "datasets")
    monkeypatch.setenv("DS", "1")
    monkeypatch.setenv("GAMMAS", "0.5 1.0")
    wrote = table2.run()
    assert wrote[0] == "gaussian/seed_5" and len(wrote) == 3
    raw2 = runs_dir / "table2" / "raw"
    rows = _same_csv(common.table2_csv, ref.table2_csv,
                     [str(raw2 / "quantum"), str(raw2 / "gaussian")], tmp_path)
    assert [(r["kernel"], r["gamma"]) for r in rows] == [("Gaussian", "--"), ("Quantum", 0.5),
                                                         ("Quantum", 1.0)]
    table2.csv()
    table2.plot()
    assert (runs_dir / "table2" / "table2.png").stat().st_size > 0


def test_runtime_suites_refuse_without_the_v1_archive(runs_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(_harness, "V1_ARCHIVE", tmp_path / "missing")
    monkeypatch.setenv("NFS", "4")
    monkeypatch.setenv("NF", "4")
    monkeypatch.setenv("DS", "1")
    for run in (qubit_scaling.run, mem_evol.run, crossover.run):
        with pytest.raises(FileNotFoundError, match="v1"):
            run()
    assert not list((runs_dir / "qubit_scaling" / "raw").iterdir())


def test_qml_figures_csv_and_plot(runs_dir):
    raw = runs_dir / "qml_figures" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for ntr in (150, 750):
        for nf in (15, 50):
            for kind in ("train", "test"):
                np.save(raw / f"{ref_run_info(kind, nf, 2, 0.1, 1, ntr, 5, 'x.csv')}.npy",
                        _metrics(rng))
    rows = qml_figures.csv()
    assert len(rows) == 8 and {r["split"] for r in rows} == {"train", "test"}
    assert all(r["best_auc"] == float(np.load(raw / f"{ref_run_info(r['split'], r['features'], 2, 0.1, 1, r['licit_data'], 5, 'x.csv')}.npy")[:, 4].max()) for r in rows)  # noqa: E501
    qml_figures.plot()
    assert (runs_dir / "qml_figures" / "qml_figures.png").stat().st_size > 0
