"""Primary entry point: the full train + test quantum-kernel SVM pipeline
(port of the reference ``cli/main.py``, same argv contract, saved files and
prints): train Gram, test Gram, then the SVC sweep over both.
``QMLTPU_DEVICE`` picks the device (default cuda). Under ``torchrun
--nproc-per-node N`` both Grams run on the multi-device ring (one process per
device; ``cli/_pipeline.py``, ``QMLTPU_MESH``); every rank gets the same
results and rank 0 writes the files.

    python -m qml_cutensornet_tpu_torch.cli.main <backend> <num_features> <layers>
        <gamma> <distance> <n_illicit> <n_licit> <data_seed> <data_file>

Returns ``(kernel_train, kernel_test, test_results, train_results)`` so that a
caller in the same process need not read the saved files back.
"""

from __future__ import annotations

import time

import numpy as np

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe
from qml_cutensornet_tpu_torch.models.svm import svc_sweep


def main(argv=None):
    params = pipe.parse_argv(argv)
    engine = pipe.engine_kwargs()
    pipe.echo_params(params, n_procs=pipe.n_procs(engine))

    x_train, y_train, x_test, y_test = pipe.prepare(params)
    ansatz = pipe.make_ansatz(params)
    train_info, test_info = pipe.info_names(params)

    time0 = time.perf_counter()
    kernel_train = pipe.build(params, ansatz, X=x_train, info_file=train_info, engine=engine)
    time1 = time.perf_counter()
    print(f"Built kernel matrix on training set. Time: {round(time1 - time0, 2)} seconds\n")
    if pipe.is_writer():
        np.save(f"kernels/{train_info}.npy", kernel_train)

    time0 = time.perf_counter()
    kernel_test = pipe.build(params, ansatz, X=x_train, Y=x_test, info_file=test_info,
                             engine=engine)
    time1 = time.perf_counter()
    print(f"Built kernel matrix on test set. Time: {round(time1 - time0, 2)} seconds\n")
    if pipe.is_writer():
        np.save(f"kernels/{test_info}.npy", kernel_test)
    print("Test Kernel\n", kernel_test)

    test_results, train_results = svc_sweep(kernel_train, y_train, kernel_test, y_test)
    if pipe.is_writer():
        np.save(f"data/{train_info}.npy", train_results)
        np.save(f"data/{test_info}.npy", test_results)
    return kernel_train, kernel_test, test_results, train_results


if __name__ == "__main__":
    main()
