"""Write a synthetic dataset with the Kaggle Elliptic schema and preprocess
it (port of the reference ``cli/make_synthetic``, numpy only): raw CSVs in
``datasets/elliptic_bitcoin_dataset`` (a no-op where a matching generation
is already there; a mismatched one raises unless ``--force``), then
``datasets/elliptic_preproc.csv``, both under the working directory.

    python -m qml_cutensornet_tpu_torch.cli.make_synthetic [n_labeled] [seed] [--force]
"""

from __future__ import annotations

import sys

from qml_cutensornet_tpu_torch.utils.data import make_synthetic_elliptic, preprocess_elliptic


def main(argv=None) -> None:
    argv = sys.argv if argv is None else argv
    n_labeled = int(argv[1]) if len(argv) > 1 else 2000
    seed = int(argv[2]) if len(argv) > 2 else 0
    make_synthetic_elliptic(n_labeled=n_labeled, seed=seed, force="--force" in argv)
    table = preprocess_elliptic()
    n0 = int((table[:, 1] == 0).sum())
    n1 = int((table[:, 1] == 1).sum())
    print(f"Wrote datasets/elliptic_preproc.csv: {len(table)} rows "
          f"({n0} illicit / {n1} licit), {table.shape[1] - 2} feature columns.")


if __name__ == "__main__":
    main()
