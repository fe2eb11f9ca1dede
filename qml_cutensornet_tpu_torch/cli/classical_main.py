"""Classical Gaussian-kernel baseline (port of the reference
``cli/classical_main.py``): the same data pipeline, an RBF-kernel C-SVC with
``gamma="scale"`` over the same C sweep, the test rows saved to
``raw/gaussian/seed_{s}.npy`` unless a path is given. Host only.

    python -m qml_cutensornet_tpu_torch.cli.classical_main <num_features>
        <n_illicit> <n_licit> <data_seed> <data_file> [out.npy]
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np

from qml_cutensornet_tpu_torch.models.svm import classical_rbf_sweep
from qml_cutensornet_tpu_torch.utils.data import load_and_prepare


def main(argv=None) -> None:
    argv = sys.argv if argv is None else argv
    if len(argv) <= 5:
        raise ValueError(
            "Call as 'python classical_main.py <num_features> <n_illicit> "
            "<n_licit> <data_seed> <data_file> [out.npy]'."
        )
    num_features = int(argv[1])
    n_illicit = int(argv[2])
    n_licit = int(argv[3])
    data_seed = int(argv[4])
    data_file = str(argv[5])
    out = argv[6] if len(argv) > 6 else f"raw/gaussian/seed_{data_seed}.npy"

    x_train, y_train, x_test, y_test = load_and_prepare(
        "datasets/" + data_file, num_features, n_illicit, n_licit, data_seed
    )
    test_results, _ = classical_rbf_sweep(x_train, y_train, x_test, y_test)
    pathlib.Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.save(out, test_results)


if __name__ == "__main__":
    main()
