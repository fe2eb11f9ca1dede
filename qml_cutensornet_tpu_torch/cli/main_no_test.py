"""Train-Gram-only entry point (port of the reference ``main_no_test``): the
data path and the train-Gram build, saved to ``kernels/{train_info}.npy``,
then exit — no test kernel, no SVC. ``QMLTPU_DEVICE`` picks the device
(default cuda); under ``torchrun --nproc-per-node N`` the Gram runs on the
multi-device ring and rank 0 writes the file.

    python -m qml_cutensornet_tpu_torch.cli.main_no_test GPU 32 2 1.0 6 64 64 5 \
        elliptic_preproc_bench.csv
"""

from __future__ import annotations

import time

import numpy as np

from qml_cutensornet_tpu_torch.cli import _pipeline as pipe


def main(argv=None) -> np.ndarray:
    params = pipe.parse_argv(argv)
    engine = pipe.engine_kwargs()
    pipe.echo_params(params, n_procs=pipe.n_procs(engine))

    x_train, y_train, x_test, y_test = pipe.prepare(params)
    ansatz = pipe.make_ansatz(params)
    train_info, _ = pipe.info_names(params)

    time0 = time.perf_counter()
    kernel_train = pipe.build(params, ansatz, X=x_train, info_file=train_info, engine=engine)
    time1 = time.perf_counter()
    print(f"Built kernel matrix on training set. Time: {round(time1 - time0, 2)} seconds\n")
    if pipe.is_writer():
        np.save(f"kernels/{train_info}.npy", kernel_train)
    return kernel_train


if __name__ == "__main__":
    main()
