"""The port's C-SVC (``models/svm.py``) against scikit-learn's
``SVC(kernel="precomputed", tol=1e-3)``, which the reference calls, over the
reference's 11-value regularization sweep, on a Gram matrix built by the
port and on an RBF kernel; then ``svc_sweep`` and ``classical_rbf_sweep``
against the reference's.

Two SMO solvers that both stop at KKT violation < tol need not reach the
same ``alpha``; what they share is the dual objective (within tol, relative
1e-3 stated here), a KKT violation below tol, and, away from exact ties on
the decision boundary, the predictions. Metric rows are arithmetic on equal
predictions, so they agree to 1e-12."""

import numpy as np
import pytest
from sklearn.metrics import accuracy_score, precision_score, recall_score, roc_auc_score
from sklearn.svm import SVC as SkSVC

from qml_cutensornet_tpu.models import svm as ref_svm
from qml_cutensornet_tpu_torch.config import SimConfig
from qml_cutensornet_tpu_torch.models import svm
from qml_cutensornet_tpu_torch.models.ansatz import KernelStateAnsatz
from qml_cutensornet_tpu_torch.models.entanglement import entanglement_graph
from qml_cutensornet_tpu_torch.models.gram import build_kernel_matrix

N_TRAIN, N_TEST, NQ = 40, 16, 6


def _data(seed):
    """Features in [0, 2] with a label that depends on them, so that the
    sweep runs from an under- to an over-regularized fit."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 2.0, size=(N_TRAIN + N_TEST, NQ))
    y = ((x[:, 0] - 1.0) * (x[:, 1] - 1.0) + 0.3 * rng.standard_normal(len(x)) > 0).astype(int)
    return x[:N_TRAIN], y[:N_TRAIN], x[N_TRAIN:], y[N_TRAIN:]


def _quantum_kernels(seed=0):
    x_tr, y_tr, x_te, y_te = _data(seed)
    ans = KernelStateAnsatz(NQ, 1, 1.0, entanglement_graph(NQ, 1))
    cfg = SimConfig(chi=8, svd_method="subspace", fused_split=True)
    k_tr = build_kernel_matrix(ans, x_tr, cfg=cfg, sim_batch=20, tile=20, device="cpu")
    k_te = build_kernel_matrix(ans, x_tr, Y=x_te, cfg=cfg, sim_batch=20, tile=20, device="cpu")
    return k_tr, y_tr, k_te, y_te


def _rbf_kernels(seed=1):
    x_tr, y_tr, x_te, y_te = _data(seed)
    gamma = 1.0 / (NQ * x_tr.var())
    return svm.rbf_kernel(x_tr, x_tr, gamma), y_tr, svm.rbf_kernel(x_te, x_tr, gamma), y_te


KERNELS = {"quantum": _quantum_kernels, "rbf": _rbf_kernels}
_CACHE = {}


def _kernels(name):
    if name not in _CACHE:
        _CACHE[name] = KERNELS[name]()
    return _CACHE[name]


def _dual_objective(k, y_signed, coef):
    alpha = coef * y_signed
    return 0.5 * coef @ k @ coef - alpha.sum()


@pytest.mark.parametrize("C", svm.REGULARIZATION_SWEEP)
@pytest.mark.parametrize("name", ["quantum", "rbf"])
def test_svc_matches_sklearn(name, C):
    k_tr, y_tr, k_te, y_te = _kernels(name)
    port = svm.SVC(C=C, tol=1e-3).fit(k_tr, y_tr)
    sk = SkSVC(kernel="precomputed", C=C, tol=1e-3).fit(k_tr, y_tr)

    # feasibility and optimality of the port's own solution
    assert port.alpha_.min() >= 0.0 and port.alpha_.max() <= C
    assert abs(port.dual_coef_.sum()) <= 1e-9 * max(1.0, C * N_TRAIN)
    assert port.kkt_violation_ <= 1e-3
    # scikit-learn's solution, scattered to all points, in the port's sign
    coef_sk = np.zeros(N_TRAIN)
    coef_sk[sk.support_] = -sk.dual_coef_[0]
    assert svm.kkt_violation(k_tr, port.y_signed_, coef_sk * port.y_signed_, C) <= 1e-3 + 1e-9
    obj_sk = _dual_objective(k_tr, port.y_signed_, coef_sk)
    assert abs(port.dual_objective_ - obj_sk) <= 1e-3 * abs(obj_sk)

    for k_eval, y_eval in ((k_te, y_te), (k_tr, y_tr)):
        dec, dec_sk = port.decision_function(k_eval), sk.decision_function(k_eval)
        np.testing.assert_allclose(dec, dec_sk, atol=5e-3)  # both within tol of the optimum
        pred, pred_sk = port.predict(k_eval), sk.predict(k_eval)
        np.testing.assert_array_equal(pred, pred_sk)
        row = svm.binary_metrics(y_eval, pred)
        row_sk = (accuracy_score(y_eval, pred_sk), precision_score(y_eval, pred_sk, zero_division=0),
                  recall_score(y_eval, pred_sk), roc_auc_score(y_eval, pred_sk))
        np.testing.assert_allclose(row, row_sk, atol=1e-12)


def test_metrics_edge_cases():
    """No predicted positive: precision 0 (scikit-learn's zero-division
    value); one class in y_true: ROC AUC undefined, raises as scikit-learn's."""
    y = np.array([0, 1, 1, 0])
    acc, prec, rec, auc = svm.binary_metrics(y, np.zeros(4, int))
    assert (acc, prec, rec, auc) == (0.5, 0.0, 0.0, 0.5)
    with pytest.raises(ValueError, match="one class"):
        svm.binary_metrics(np.ones(4, int), y)
    with pytest.raises(ValueError, match="two classes"):
        svm.SVC().fit(np.eye(3), np.ones(3))


@pytest.mark.filterwarnings("ignore::sklearn.exceptions.UndefinedMetricWarning")
def test_sweeps_match_reference(capsys):
    k_tr, y_tr, k_te, y_te = _kernels("quantum")
    assert svm.REGULARIZATION_SWEEP == ref_svm.REGULARIZATION_SWEEP
    port = svm.svc_sweep(k_tr, y_tr, k_te, y_te)
    port_out = capsys.readouterr().out
    ref = ref_svm.svc_sweep(k_tr, y_tr, k_te, y_te)
    ref_out = capsys.readouterr().out
    for rows, rows_ref in zip(port, ref):
        assert len(rows) == 11
        np.testing.assert_allclose(np.asarray(rows), np.asarray(rows_ref), atol=1e-12)
    # same prints, line for line (values are Python floats on both sides)
    assert [ln.split(":")[0] for ln in port_out.splitlines()] == [
        ln.split(":")[0] for ln in ref_out.splitlines()]

    x_tr, y_tr, x_te, y_te = _data(1)
    port = svm.classical_rbf_sweep(x_tr, y_tr, x_te, y_te, verbose=False)
    ref = ref_svm.classical_rbf_sweep(x_tr, y_tr, x_te, y_te, verbose=False)
    for rows, rows_ref in zip(port, ref):
        np.testing.assert_allclose(np.asarray(rows), np.asarray(rows_ref), atol=1e-12)
