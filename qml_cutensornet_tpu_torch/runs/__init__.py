"""The experiment harness on the port: one module a single-card suite of the
reference's ``runs/`` (qubit_scaling, mem_evol, crossover, table2, table3,
qml_figures), each with the steps ``run`` (the CLIs in-process, on the card
unless ``QMLTPU_DEVICE=cpu``), ``csv`` (the reference's schema, by
:mod:`.common`) and ``plot`` (matplotlib, imported when called):

    python -m qml_cutensornet_tpu_torch.runs.<suite> run|csv|plot

Outputs go to ``runs_torch/<suite>/`` or ``$QMLTPU_RUNS_DIR/<suite>/``
(:mod:`._harness`). ``runtime_scaling`` needs two or more cards and is not
here.
"""
