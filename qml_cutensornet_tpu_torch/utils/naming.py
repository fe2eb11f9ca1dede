"""Run-info filename convention (reference C21).

The reference encodes run identity in the info-file name
(main.py:161-162) and the experiment harness parses fields back out
positionally (runs/runtime_scaling/to_csv.py:17-30):

    {train|test}_Nf{nf}_r{reps}_g{gamma}_p0.0_nn{d}_mslinear_Ntr{n_illicit}_s{seed}_{dataset}

``p`` is the edge probability (always 0.0) and ``ms`` the map style
(always "linear") — vestigial fields kept for parse compatibility.
"""

from __future__ import annotations


def run_info(
    prefix: str,
    num_features: int,
    reps: int,
    gamma: float,
    nearest_neighbors: int,
    n_illicit: int,
    data_seed: int,
    data_file: str,
) -> str:
    dataset = data_file.split(".")[0]
    return (
        f"{prefix}_Nf{num_features}_r{reps}_g{gamma}_p0.0_nn{nearest_neighbors}"
        f"_mslinear_Ntr{n_illicit}_s{data_seed}_{dataset}"
    )


def parse_run_info(name: str) -> dict:
    """Inverse of ``run_info`` (positional, like the reference to_csv
    scripts)."""
    parts = name.split("_")
    return {
        "prefix": parts[0],
        "num_features": int(parts[1][2:]),
        "reps": int(parts[2][1:]),
        "gamma": float(parts[3][1:]),
        "edge_prob": float(parts[4][1:]),
        "nearest_neighbors": int(parts[5][2:]),
        "map_style": parts[6][2:],
        "n_illicit": int(parts[7][3:]),
        "data_seed": int(parts[8][1:]),
        "dataset": "_".join(parts[9:]),
    }
