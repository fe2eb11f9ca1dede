"""Shared aggregation of the experiment harness (port of ``runs/common.py``,
without pandas).

Each function reads the raw files a suite's ``run`` step wrote (profiling
JSONs named by :func:`~qml_cutensornet_tpu_torch.utils.naming.run_info`,
metric ``.npy`` dumps, memory captures) and writes the CSV of the
reference's schema: the same columns in the same order, the rows in sorted
file order, and the same text as ``pandas.DataFrame(rows).to_csv(index=False)``
(:func:`write_csv`). Each returns its rows as a list of dicts.
"""

from __future__ import annotations

import csv
import json
import os
from collections import defaultdict

import numpy as np

from qml_cutensornet_tpu_torch.utils.naming import parse_run_info


def _column_kind(values) -> str:
    """The dtype pandas infers for a column of these Python values: "int",
    "float" (ints and floats mixed, or numbers beside None), "bool", else
    "object"."""
    present = [v for v in values if v is not None]
    if not present:
        return "object"
    if all(isinstance(v, (bool, np.bool_)) for v in present):
        return "bool" if len(present) == len(values) else "object"
    numbers = all(isinstance(v, (int, float, np.integer, np.floating))
                  and not isinstance(v, (bool, np.bool_)) for v in present)
    if not numbers:
        return "object"
    if len(present) < len(values) or any(isinstance(v, (float, np.floating)) for v in present):
        return "float"
    return "int"


def _cell(value, kind: str) -> str:
    if value is None:
        return ""
    if kind == "float":
        return repr(float(value))
    if kind == "int":
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return repr(float(value))
    return str(value)


def write_csv(rows: list[dict], out_csv: str) -> None:
    """``rows`` as pandas writes ``DataFrame(rows).to_csv(out_csv,
    index=False)``: columns in order of first appearance, floats as their
    ``repr``, None as an empty field, an int column beside a float or a None
    written as floats, '\\n' line ends."""
    columns: list = []
    for row in rows:
        columns.extend(k for k in row if k not in columns)
    kinds = {c: _column_kind([row.get(c) for row in rows]) for c in columns}
    with open(out_csv, "w", newline="") as fp:
        if not columns:
            fp.write("\n")
            return
        writer = csv.writer(fp, lineterminator="\n")
        writer.writerow(columns)
        for row in rows:
            writer.writerow([_cell(row.get(c), kinds[c]) for c in columns])


def read_csv(path: str) -> list[dict]:
    """The rows of a CSV written by :func:`write_csv`, every value a string."""
    with open(path, newline="") as fp:
        return list(csv.DictReader(fp))


def load_profiles(directory: str) -> list[tuple[dict, dict]]:
    """All (params, profiling) pairs from ``{run_info}.json`` files."""
    out = []
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".json"):
            continue
        name = f[: -len(".json")]
        params = parse_run_info(name)
        with open(os.path.join(directory, f)) as fp:
            out.append((params, json.load(fp)))
    return out


def _common_fields(params: dict) -> dict:
    return {
        "data_set": params["dataset"].split(".csv")[0],
        "kernel": params["prefix"],
        "features": params["num_features"],
        "licit_data": params["n_illicit"],
        "entanglement": params["map_style"],
        "layers": params["reps"],
        "gamma": params["gamma"],
        "edge_prob": params["edge_prob"],
        "neighbours": params["nearest_neighbors"],
        "seed": params["data_seed"],
    }


def avg_max_chi(prof: dict) -> float:
    """The mean of a profile's x and y ``ave max chi``."""
    return (prof["ave max chi x"][0] + prof["ave max chi y"][0]) / 2


def runtime_scaling_csv(raw_dir: str, out_csv: str) -> list[dict]:
    """Schema of runs/runtime_scaling/to_csv.py."""
    rows = []
    for params, prof in load_profiles(raw_dir):
        row = _common_fields(params)
        row.update(
            n_procs=prof["n_procs"][0],
            mps_wall_time=prof["r0_circ_sim"][0],
            dot_wall_time=prof["r0_product"][0],
            mpi_wall_time=prof["r0_RR_recv"][0],
            total_wall_time=prof["total_time"][0],
            avg_max_chi=avg_max_chi(prof),
            avg_mps_mem=prof["avg_mps_mem"][0],
        )
        rows.append(row)
    write_csv(rows, out_csv)
    return rows


def qubit_scaling_csv(raw_dir: str, out_csv: str) -> list[dict]:
    """Schema of runs/qubit_scaling/to_csv.py."""
    rows = []
    for params, prof in load_profiles(raw_dir):
        row = _common_fields(params)
        row.update(
            avg_mps_time=prof["avg_circ_sim"][0],
            avg_dot_time=prof["avg_product"][0],
            avg_max_chi=avg_max_chi(prof),
            avg_mps_mem=prof["avg_mps_mem"][0],
        )
        rows.append(row)
    write_csv(rows, out_csv)
    return rows


def crossover_csv(raw_dir: str, out_csv: str, with_mem: bool = True) -> list[dict]:
    """Schema of runs/crossover/to_csv.py (the gpu variant includes memory),
    with the trailing ``config`` column: a record's name suffix (e.g.
    ``_brick_chi128``) is folded into ``dataset`` by the positional parser,
    so that two configurations of one (nf, d) point stay apart."""
    rows = []
    for params, prof in load_profiles(raw_dir):
        row = {
            "features": params["num_features"],
            "entanglement": params["map_style"],
            "layers": params["reps"],
            "gamma": params["gamma"],
            "neighbours": params["nearest_neighbors"],
            "seed": params["data_seed"],
            "median_mps_time": prof["median_circ_sim"][0],
            "median_dot_time": prof["median_product"][0],
            "avg_max_chi": avg_max_chi(prof),
            "q1_mps_time": prof["q1_circ_sim"][0],
            "q3_mps_time": prof["q3_circ_sim"][0],
            "q1_dot_time": prof["q1_product"][0],
            "q3_dot_time": prof["q3_product"][0],
        }
        if with_mem:
            row["avg_mps_mem"] = prof["avg_mps_mem"][0]
        row["config"] = params["dataset"]
        rows.append(row)
    write_csv(rows, out_csv)
    return rows


def _best_by_auc(metric_rows: dict) -> dict:
    """Average each metric per key, return the entry with the best AUC (the
    first of equal maxima)."""
    avg = {k: [np.mean(v) for v in vals] for k, vals in metric_rows.items()}
    aucs = avg["auc"]
    i = aucs.index(max(aucs))
    return {m: avg[m][i] for m in avg}


def collect_metric_npys(directory: str, key_fn) -> dict:
    """Aggregate ``data/{run_info}.npy`` metric dumps: rows are [C, accuracy,
    precision, recall, auc]. ``key_fn(params)`` groups runs; within a group,
    metrics are averaged per (C, key) over seeds and the best-AUC row is
    chosen (the reference's table logic)."""
    groups: dict = defaultdict(lambda: defaultdict(lambda: defaultdict(list)))
    for f in sorted(os.listdir(directory)):
        if not f.endswith(".npy"):
            continue
        params = parse_run_info(f[: -len(".npy")])
        if params["prefix"] != "test":
            continue
        key = key_fn(params)
        for row in np.load(os.path.join(directory, f)):
            reg = row[0]
            groups[key][reg]["accuracy"].append(row[1])
            groups[key][reg]["precision"].append(row[2])
            groups[key][reg]["recall"].append(row[3])
            groups[key][reg]["auc"].append(row[4])
    results = {}
    for key, per_reg in groups.items():
        merged: dict = defaultdict(dict)
        for reg, metrics in per_reg.items():
            for m, vals in metrics.items():
                merged[m][reg] = vals
        results[key] = _best_by_auc({m: list(d.values()) for m, d in merged.items()})
    return results


def _metric_row(best: dict) -> dict:
    return {"AUC": best["auc"], "recall": best["recall"], "precision": best["precision"],
            "accuracy": best["accuracy"]}


def table2_csv(quantum_dir: str, gaussian_dir: str, out_csv: str) -> list[dict]:
    """Schema of runs/table2/to_csv.py: the Gaussian baseline row, then one
    row per (gamma, d) quantum configuration, best AUC over the C sweep,
    averaged over seeds."""
    gauss: dict = defaultdict(lambda: defaultdict(list))
    for f in sorted(os.listdir(gaussian_dir)):
        if not f.endswith(".npy"):
            continue
        for row in np.load(os.path.join(gaussian_dir, f)):
            gauss[row[0]]["accuracy"].append(row[1])
            gauss[row[0]]["precision"].append(row[2])
            gauss[row[0]]["recall"].append(row[3])
            gauss[row[0]]["auc"].append(row[4])
    flat = {m: [np.mean(gauss[reg][m]) for reg in gauss]
            for m in ("accuracy", "precision", "recall", "auc")}
    rows = [{"kernel": "Gaussian", "d": "--", "gamma": "--", **_metric_row(_best_by_auc(flat))}]
    quantum = collect_metric_npys(quantum_dir, lambda p: (p["gamma"], p["nearest_neighbors"]))
    for (gamma, d), best in sorted(quantum.items()):
        rows.append({"kernel": "Quantum", "d": d, "gamma": gamma, **_metric_row(best)})
    write_csv(rows, out_csv)
    return rows


def table3_csv(raw_dir: str, out_csv: str) -> list[dict]:
    """Schema of runs/table3/to_csv.py: one row per circuit depth."""
    by_depth = collect_metric_npys(raw_dir, lambda p: p["reps"])
    rows = [{"depth": depth, **_metric_row(best)} for depth, best in sorted(by_depth.items())]
    write_csv(rows, out_csv)
    return rows


def mem_evol_series(raw_dir: str) -> dict[str, list[float]]:
    """Parse the per-op ``MPS size ... = <float>`` lines of each capture in
    ``raw_dir`` (runs/mem_evol/plot.py's convention)."""
    out = {}
    for f in sorted(os.listdir(raw_dir)):
        path = os.path.join(raw_dir, f)
        if not os.path.isfile(path):
            continue
        sizes = []
        with open(path) as fp:
            for line in fp:
                if "MPS size" in line:
                    sizes.append(float(line.split("=")[1]))
        out[f] = sizes
    return out
