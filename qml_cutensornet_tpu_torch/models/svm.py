"""Classical ML layer: C-SVC on the precomputed quantum kernel (port of
``qml_cutensornet_tpu/models/svm.py``).

The reference fits scikit-learn's ``SVC(kernel="precomputed", C, tol=1e-3)``;
the port carries its own solver, because the machines it runs on need not
have scikit-learn: :class:`SVC` solves the same dual

    min_a  1/2 a^T Q a - e^T a,   0 <= a_i <= C,   y^T a = 0,
    Q_ij = y_i y_j K_ij

by sequential minimal optimization with second-order working-set selection
(Fan, Chen and Lin 2005, the method of libsvm, which scikit-learn wraps),
with the same stopping rule (largest KKT violation below ``tol``), the same
bias rule and the same class orientation. It runs in numpy float64 on the
host, like the reference's: the matrices are about 100 x 100. Two solvers
that both meet ``tol`` agree on the dual objective to about ``tol`` and can
differ in ``alpha``; the tests hold this one to scikit-learn on objective,
KKT violation, predictions and metric rows.

``svc_sweep`` and ``classical_rbf_sweep`` keep the reference's names,
regularization sweep, prints and row layout ``[C, accuracy, precision,
recall, auc]``; the four metrics are computed on hard predictions, as the
reference computes them.
"""

from __future__ import annotations

import numpy as np

# The reference's regularization sweep (main.py:197).
REGULARIZATION_SWEEP = [4, 3.5, 3, 2.5, 2, 1.5, 1, 0.5, 0.1, 0.05, 0.01]

_TAU = 1e-12  # floor of the pair's curvature, as in libsvm


def _last_argmax(v: np.ndarray) -> int:
    """Index of the maximum, the last one among ties (libsvm scans with >=)."""
    return len(v) - 1 - int(np.argmax(v[::-1]))


def kkt_violation(kernel: np.ndarray, y_signed: np.ndarray, alpha: np.ndarray, C: float) -> float:
    """Largest violation ``m(a) - M(a)`` of the dual's optimality conditions
    at ``alpha``, with ``m = max_{I_up} -y_i G_i`` and ``M = min_{I_low}
    -y_i G_i`` for the gradient ``G = Q a - e``; the solver stops when it is
    below ``tol``. ``y_signed`` holds +1 / -1."""
    g = y_signed * (kernel @ (alpha * y_signed)) - 1.0
    up = ((y_signed > 0) & (alpha < C)) | ((y_signed < 0) & (alpha > 0))
    low = ((y_signed > 0) & (alpha > 0)) | ((y_signed < 0) & (alpha < C))
    if not up.any() or not low.any():
        return 0.0
    return float(np.max(-(y_signed * g)[up]) - np.min(-(y_signed * g)[low]))


class SVC:
    """Binary C-SVC for a precomputed kernel. ``fit(K_train [n, n], y)`` with
    two classes; ``decision_function(K [m, n])`` is positive toward the
    larger class label, ``predict`` returns class labels."""

    def __init__(self, C: float = 1.0, tol: float = 1e-3):
        if C <= 0:
            raise ValueError("C must be positive")
        self.C = float(C)
        self.tol = float(tol)

    def fit(self, kernel, y) -> "SVC":
        K = np.asarray(kernel, dtype=np.float64)
        y = np.asarray(y)
        if K.ndim != 2 or K.shape[0] != K.shape[1] or K.shape[0] != y.shape[0]:
            raise ValueError(f"expected a square kernel [n, n] and y [n]; got {K.shape}, {y.shape}")
        self.classes_ = np.unique(y)
        if len(self.classes_) != 2:
            raise ValueError(f"SVC needs exactly two classes, got {self.classes_}")
        # libsvm's orientation under scikit-learn: the smaller label is +1.
        ys = np.where(y == self.classes_[0], 1.0, -1.0)
        self.alpha_, self.rho_, self.n_iter_ = self._solve(K, ys)
        self.y_signed_ = ys
        self.dual_coef_ = self.alpha_ * ys
        self.dual_objective_ = float(
            0.5 * self.dual_coef_ @ K @ self.dual_coef_ - self.alpha_.sum())
        self.kkt_violation_ = kkt_violation(K, ys, self.alpha_, self.C)
        return self

    def _solve(self, K: np.ndarray, y: np.ndarray):
        n, C, eps = len(y), self.C, self.tol
        alpha = np.zeros(n)
        G = -np.ones(n)
        QD = np.diag(K).copy()
        pos = y > 0
        max_iter = max(10_000_000, 100 * n)
        it = 0
        while it < max_iter:
            # Working set: i maximizes -y G over I_up; j minimizes the
            # second-order estimate of the objective decrease over I_low.
            up = np.where(pos, alpha < C, alpha > 0)
            low = np.where(pos, alpha > 0, alpha < C)
            myg = -y * G
            cand = np.where(up, myg, -np.inf)
            i = _last_argmax(cand)
            gmax = cand[i]
            if not np.isfinite(gmax):
                break
            Qi = y[i] * y * K[i]
            gmax2 = np.max(np.where(low, -myg, -np.inf))
            grad_diff = gmax - myg
            ok = low & (grad_diff > 0)
            if gmax + gmax2 < eps or not ok.any():
                break
            # y_i y_j Q_ij = K_ij: the pair's curvature along the feasible direction
            quad = QD[i] + QD - 2.0 * K[i]
            quad = np.where(quad > 0, quad, _TAU)
            obj = np.where(ok, -(grad_diff * grad_diff) / quad, np.inf)
            j = _last_argmax(-obj)

            Qj = y[j] * y * K[j]
            ai, aj = alpha[i], alpha[j]
            if y[i] != y[j]:
                q = QD[i] + QD[j] + 2.0 * Qi[j]
                delta = (-G[i] - G[j]) / (q if q > 0 else _TAU)
                diff = ai - aj
                alpha[i] += delta
                alpha[j] += delta
                if diff > 0:
                    if alpha[j] < 0:
                        alpha[j], alpha[i] = 0.0, diff
                elif alpha[i] < 0:
                    alpha[i], alpha[j] = 0.0, -diff
                if diff > 0:  # C_i == C_j == C
                    if alpha[i] > C:
                        alpha[i], alpha[j] = C, C - diff
                elif alpha[j] > C:
                    alpha[j], alpha[i] = C, C + diff
            else:
                q = QD[i] + QD[j] - 2.0 * Qi[j]
                delta = (G[i] - G[j]) / (q if q > 0 else _TAU)
                tot = ai + aj
                alpha[i] -= delta
                alpha[j] += delta
                if tot > C:
                    if alpha[i] > C:
                        alpha[i], alpha[j] = C, tot - C
                elif alpha[j] < 0:
                    alpha[j], alpha[i] = 0.0, tot
                if tot > C:
                    if alpha[j] > C:
                        alpha[j], alpha[i] = C, tot - C
                elif alpha[i] < 0:
                    alpha[i], alpha[j] = 0.0, tot
            G += Qi * (alpha[i] - ai) + Qj * (alpha[j] - aj)
            it += 1

        # Bias: mean of y G over the free vectors, else the midpoint of its bounds.
        yg = y * G
        at_upper, at_lower = alpha >= C, alpha <= 0
        free = ~at_upper & ~at_lower
        if free.any():
            rho = float(yg[free].mean())
        else:
            ub_set = (at_upper & ~pos) | (at_lower & pos)
            lb_set = (at_upper & pos) | (at_lower & ~pos)
            ub = yg[ub_set].min() if ub_set.any() else np.inf
            lb = yg[lb_set].max() if lb_set.any() else -np.inf
            rho = float((ub + lb) / 2.0)
        return alpha, rho, it

    def decision_function(self, kernel) -> np.ndarray:
        """``kernel [m, n]`` against the training points -> ``[m]``, positive
        toward ``classes_[1]``."""
        K = np.asarray(kernel, dtype=np.float64)
        return -(K @ self.dual_coef_ - self.rho_)

    def predict(self, kernel) -> np.ndarray:
        dec = self.decision_function(kernel)
        return np.where(dec >= 0, self.classes_[1], self.classes_[0])


def rbf_kernel(x, z, gamma: float) -> np.ndarray:
    """``exp(-gamma |x_i - z_j|^2)`` for rows of ``x [m, f]`` and ``z [n, f]``."""
    x, z = np.asarray(x, dtype=np.float64), np.asarray(z, dtype=np.float64)
    d2 = (x * x).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2.0 * (x @ z.T)
    return np.exp(-gamma * np.maximum(d2, 0.0))


def binary_metrics(y_true, y_pred) -> tuple[float, float, float, float]:
    """``(accuracy, precision, recall, roc_auc)`` of hard predictions with
    positive label 1. Precision and recall are 0 where their denominator is
    0; the ROC AUC of a hard labelling is the mean of the true-positive and
    true-negative rates and needs both classes in ``y_true``."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    tp = int(np.sum((y_pred == 1) & (y_true == 1)))
    fp = int(np.sum((y_pred == 1) & (y_true != 1)))
    fn = int(np.sum((y_pred != 1) & (y_true == 1)))
    tn = int(np.sum((y_pred != 1) & (y_true != 1)))
    if tp + fn == 0 or fp + tn == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined "
                         "in that case.")
    accuracy = float(np.mean(y_pred == y_true))
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn)
    auc = 0.5 * (recall + tn / (fp + tn))
    return accuracy, precision, recall, auc


def _metric_rows(kernel_fit, fit_y, kernel_eval, eval_y, reg, verbose):
    results = []
    for r in reg:
        if verbose:
            print("coeff: ", r)
        svc = SVC(C=r, tol=1e-3).fit(kernel_fit, fit_y)
        accuracy, precision, recall, auc = binary_metrics(eval_y, svc.predict(kernel_eval))
        if verbose:
            print("accuracy: ", accuracy)
            print("precision: ", precision)
            print("recall: ", recall)
            print("auc: ", auc)
        results.append([r, accuracy, precision, recall, auc])
    return results


def svc_sweep(kernel_train, y_train, kernel_test, y_test, reg=None, verbose: bool = True):
    """Reference main.py:196-236: returns (test_results, train_results),
    each a list of ``[C, accuracy, precision, recall, auc]`` rows.
    ``kernel_train [n, n]``, ``kernel_test [m, n]``."""
    reg = REGULARIZATION_SWEEP if reg is None else reg
    test_results = _metric_rows(kernel_train, y_train, kernel_test, y_test, reg, verbose)
    if verbose:
        print("\n Train Results\n")
    train_results = _metric_rows(kernel_train, y_train, kernel_train, y_train, reg, verbose)
    return test_results, train_results


def classical_rbf_sweep(x_train, y_train, x_test, y_test, reg=None, verbose=True):
    """Gaussian-kernel baseline: the RBF kernel with scikit-learn's
    ``gamma="scale"`` (``1 / (n_features * x_train.var())``) over the same C
    sweep."""
    reg = REGULARIZATION_SWEEP if reg is None else reg
    x_train = np.asarray(x_train, dtype=np.float64)
    gamma = 1.0 / (x_train.shape[1] * x_train.var())
    k_train = rbf_kernel(x_train, x_train, gamma)
    k_test = rbf_kernel(x_test, x_train, gamma)
    test_results = _metric_rows(k_train, y_train, k_test, y_test, reg, verbose)
    train_results = _metric_rows(k_train, y_train, k_train, y_train, reg, verbose)
    return test_results, train_results
