"""Data layer with numpy + scipy only (port of
``qml_cutensornet_tpu/utils/data.py``, which uses pandas and scikit-learn).

The chi statistics of the MPS engine depend on the exact post-scaler
features, so this module reproduces the reference pipeline value for value
(the tests hold it to 1e-12 against the pandas/sklearn original):

- :func:`preprocess_elliptic`: drop 'unknown' rows, remap class "1"
  (illicit) -> 0 and "2" (licit) -> 1, inner-join classes and features on
  Node (left order), drop Node/Time, and write the CSV WITH the row index as
  its first column — the reference quirk that makes the index "feature 0".
- :func:`draw_sample`: pandas' ``DataFrame.sample(k, random_state=s)`` is
  ``np.random.RandomState(s).choice(n, k, replace=False)``; sklearn's
  stratified ``train_test_split`` is re-implemented (StratifiedShuffleSplit
  with its ``_approximate_mode`` allocation and the same RandomState draws).
- :func:`scale_features`: QuantileTransformer(output_distribution="normal")
  -> StandardScaler -> MinMaxScaler((0, 2)), each fit on train only, with
  sklearn's formulas and operation order.
- :func:`make_synthetic_elliptic`: the reference's synthetic raw CSVs with
  the Kaggle Elliptic schema (generator version 2), the same numpy draws in
  the same order, written without pandas; they parse to the reference's
  arrays for the same arguments.
"""

from __future__ import annotations

import json
import math
import pathlib

import numpy as np
from scipy import stats

N_FEATURES_RAW = 165

# sklearn.preprocessing._data.BOUNDS_THRESHOLD
_BOUNDS_THRESHOLD = 1e-7


def _read_raw_csv(path: str) -> list[list[str]]:
    with open(path, encoding="utf-8") as fh:
        return [line.rstrip("\r\n").split(",") for line in fh if line.strip()]


def preprocess_elliptic(
    dataset_dir: str = "datasets/elliptic_bitcoin_dataset",
    out_csv: str = "datasets/elliptic_preproc.csv",
) -> np.ndarray:
    """Read the raw Kaggle CSVs, drop 'unknown' rows, remap classes, join on
    Node, drop Node/Time and write ``out_csv`` with the reference's layout:
    header ``,Class,Feature 1,...,Feature 165`` and the row index first.
    Returns the written table ``[N, 1 + 1 + 165]`` (index, class, features)
    as float64."""
    feats = _read_raw_csv(f"{dataset_dir}/elliptic_txs_features.csv")
    classes = _read_raw_csv(f"{dataset_dir}/elliptic_txs_classes.csv")
    cls_code = [99 if c == "unknown" else (0 if c == "1" else 1) for _, c in classes]
    # The reference drops the unknown rows by POSITION from both tables
    # (pandas drop on the default RangeIndex), then inner-joins on Node in
    # the order of the class table.
    drop = {i for i, c in enumerate(cls_code) if c == 99}
    by_node: dict[str, list[int]] = {}
    for i, row in enumerate(feats):
        if i not in drop:
            by_node.setdefault(row[0], []).append(i)
    rows = []
    for i, (node, _) in enumerate(classes):
        if i in drop:
            continue
        for j in by_node.get(node, []):
            rows.append((cls_code[i], feats[j][2:]))

    labels = ["Class"] + [f"Feature {i + 1}" for i in range(N_FEATURES_RAW)]
    out = np.empty((len(rows), 2 + N_FEATURES_RAW), dtype=np.float64)
    lines = ["," + ",".join(labels)]
    for idx, (c, fvals) in enumerate(rows):
        vals = [float(v) for v in fvals]
        out[idx, 0] = idx
        out[idx, 1] = c
        out[idx, 2:] = vals
        lines.append(f"{idx},{c}," + ",".join(repr(v) for v in vals))
    pathlib.Path(out_csv).parent.mkdir(parents=True, exist_ok=True)
    pathlib.Path(out_csv).write_text("\n".join(lines) + "\n", encoding="utf-8")
    return out


def read_preprocessed(data_csv: str) -> np.ndarray:
    """The preprocessed CSV as float64 ``[N, 2 + 165]``: index, class,
    features (the column order ``pandas.read_csv`` sees)."""
    return np.loadtxt(data_csv, delimiter=",", skiprows=1, dtype=np.float64, ndmin=2)


def _approximate_mode(class_counts: np.ndarray, n_draws: int, rng) -> np.ndarray:
    """sklearn.utils.extmath._approximate_mode."""
    continuous = class_counts / class_counts.sum() * n_draws
    floored = np.floor(continuous)
    need_to_add = int(n_draws - floored.sum())
    if need_to_add > 0:
        remainder = continuous - floored
        values = np.sort(np.unique(remainder))[::-1]
        for value in values:
            (inds,) = np.where(remainder == value)
            add_now = min(len(inds), need_to_add)
            inds = rng.choice(inds, size=add_now, replace=False)
            floored[inds] += 1
            need_to_add -= add_now
            if need_to_add == 0:
                break
    return floored.astype(int)


def _stratified_split(y: np.ndarray, test_frac: float, seed: int):
    """``next(StratifiedShuffleSplit(test_size, random_state=seed).split(X, y))``
    with sklearn's sizes (``n_test = ceil(test_frac * n)``)."""
    n = len(y)
    n_test = math.ceil(test_frac * n)
    n_train = n - n_test
    classes, y_indices, class_counts = np.unique(
        y, return_inverse=True, return_counts=True)
    if class_counts.min() < 2:
        raise ValueError("every class needs at least 2 members to stratify")
    class_indices = np.split(
        np.argsort(y_indices, kind="stable"), np.cumsum(class_counts)[:-1])
    rng = np.random.RandomState(seed)
    n_i = _approximate_mode(class_counts, n_train, rng)
    t_i = _approximate_mode(class_counts - n_i, n_test, rng)
    train, test = [], []
    for i in range(len(classes)):
        perm = rng.permutation(class_counts[i])
        idx = class_indices[i].take(perm, mode="clip")
        train.extend(idx[: n_i[i]])
        test.extend(idx[n_i[i]: n_i[i] + t_i[i]])
    return rng.permutation(train), rng.permutation(test)


def draw_sample(table: np.ndarray, ndmin: int, ndmaj: int, test_frac: float = 0.2,
                seed: int = 123):
    """Class-balanced stratified sampling with the reference's derived seeds
    (class-0 sample seed*20+2, class-1 sample seed*46+9, split seed*26+19).
    ``table`` is :func:`read_preprocessed` output. Returns (x_train,
    y_train, x_test, y_test); x keeps the index column as feature 0."""
    cls = table[:, 1]
    c0 = np.flatnonzero(cls == 0)
    c1 = np.flatnonzero(cls == 1)
    pick0 = np.random.RandomState(seed * 20 + 2).choice(len(c0), size=ndmin, replace=False)
    pick1 = np.random.RandomState(seed * 46 + 9).choice(len(c1), size=ndmaj, replace=False)
    reduced = table[np.concatenate([c0[pick0], c1[pick1]])]
    train, test = _stratified_split(reduced[:, 1], test_frac, seed * 26 + 19)
    x = np.delete(reduced, 1, axis=1)
    y = reduced[:, 1].astype(int)
    return x[train], y[train], x[test], y[test]


def _quantile_fit(x: np.ndarray):
    n_q = max(1, min(1000, x.shape[0]))
    references = np.linspace(0, 1, n_q, endpoint=True)
    return np.nanpercentile(x, references * 100, axis=0), references


def _quantile_transform(x: np.ndarray, quantiles: np.ndarray, references: np.ndarray):
    """sklearn QuantileTransformer._transform_col (forward, normal output)."""
    x = np.array(x, dtype=np.float64, copy=True)
    clip_min = stats.norm.ppf(_BOUNDS_THRESHOLD - np.spacing(1))
    clip_max = stats.norm.ppf(1 - (_BOUNDS_THRESHOLD - np.spacing(1)))
    for f in range(x.shape[1]):
        col = x[:, f]
        q = quantiles[:, f]
        lower = col - _BOUNDS_THRESHOLD < q[0]
        upper = col + _BOUNDS_THRESHOLD > q[-1]
        finite = ~np.isnan(col)
        cf = col[finite]
        col[finite] = 0.5 * (
            np.interp(cf, q, references)
            - np.interp(-cf, -q[::-1], -references[::-1])
        )
        col[upper] = 1
        col[lower] = 0
        x[:, f] = np.clip(stats.norm.ppf(col), clip_min, clip_max)
    return x


def _standard_fit(x: np.ndarray):
    """StandardScaler.fit via sklearn's _incremental_mean_and_var (fresh)."""
    n = x.shape[0]
    new_sum = np.sum(x, axis=0)
    mean = new_sum / n
    temp = x - new_sum / n
    correction = np.sum(temp, axis=0)
    var = (np.sum(temp ** 2, axis=0) - correction ** 2 / n) / n
    eps = np.finfo(np.float64).eps
    constant = var <= n * eps * var + (n * mean * eps) ** 2
    scale = np.sqrt(var)
    scale[constant] = 1.0
    return mean, scale


def _minmax_fit(x: np.ndarray, lo: float = 0.0, hi: float = 2.0):
    data_min = np.nanmin(x, axis=0)
    data_range = np.nanmax(x, axis=0) - data_min
    data_range = np.where(data_range < 10 * np.finfo(np.float64).eps, 1.0, data_range)
    scale = (hi - lo) / data_range
    return scale, lo - data_min * scale


def scale_features(x_train: np.ndarray, x_test: np.ndarray):
    """Quantile-normal -> standardize -> min-max to (0, 2), each fit on train."""
    quantiles, refs = _quantile_fit(x_train)
    x_train = _quantile_transform(x_train, quantiles, refs)
    x_test = _quantile_transform(x_test, quantiles, refs)

    mean, scale = _standard_fit(x_train)
    x_train = (x_train - mean) / scale
    x_test = (x_test - mean) / scale

    mm_scale, mm_min = _minmax_fit(x_train)
    return x_train * mm_scale + mm_min, x_test * mm_scale + mm_min


def load_and_prepare(data_csv: str, num_features: int, n_illicit: int, n_licit: int,
                     data_seed: int):
    """The reference data path: read the preprocessed CSV, sample, scale,
    keep the first ``num_features`` columns."""
    table = read_preprocessed(data_csv)
    x_train, y_train, x_test, y_test = draw_sample(table, n_illicit, n_licit, 0.2, data_seed)
    x_train, x_test = scale_features(x_train, x_test)
    return x_train[:, :num_features], y_train, x_test[:, :num_features], y_test


def make_synthetic_elliptic(
    dataset_dir: str = "datasets/elliptic_bitcoin_dataset",
    n_labeled: int = 2000,
    n_unknown: int = 500,
    illicit_frac: float = 0.25,
    seed: int = 0,
    force: bool = False,
    n_clusters: int = 32,
    n_levels: int = 9,
    sparsity: float = 0.6,
    tilt: float = 1.2,
    jitter_p: float = 0.02,
    flip: float = 0.095,
) -> None:
    """Write ``elliptic_txs_features.csv`` and ``elliptic_txs_classes.csv``
    with the Kaggle Elliptic schema into ``dataset_dir``: the reference's
    generator version 2 (class-owned cluster prototypes on a discrete level
    grid, zero-inflated at ``sparsity`` and tilted by class; each sample
    moves one level on a ``jitter_p`` fraction of features; ``flip`` of the
    labeled rows change class).

    The committed golden is pinned to the committed raw CSVs, so a
    ``.provenance.json`` records the generation parameters: a call matching
    it does nothing, and a mismatched one raises unless ``force=True``."""
    params = {
        "version": 2,
        "n_labeled": n_labeled,
        "n_unknown": n_unknown,
        "illicit_frac": illicit_frac,
        "seed": seed,
        "n_clusters": n_clusters,
        "n_levels": n_levels,
        "sparsity": sparsity,
        "tilt": tilt,
        "jitter_p": jitter_p,
        "flip": flip,
    }
    prov = pathlib.Path(dataset_dir) / ".provenance.json"
    raw = pathlib.Path(dataset_dir) / "elliptic_txs_features.csv"
    if raw.is_file() and not force:
        existing = json.loads(prov.read_text()) if prov.is_file() else None
        if existing == params:
            return  # identical dataset already on disk
        raise RuntimeError(
            f"datasets at {dataset_dir} exist (provenance: {existing}); "
            f"refusing to overwrite with {params}: the committed golden is "
            "pinned to them. Pass force=True to regenerate anyway.")
    rng = np.random.default_rng(seed)
    n = n_labeled + n_unknown
    # Indices into arange(10_000_000, 99_999_999), drawn as the reference
    # draws them, without materialising that range.
    node_ids = rng.choice(99_999_999 - 10_000_000, size=n, replace=False) + 10_000_000
    times = rng.integers(1, 50, size=n)

    labels = np.full(n, "unknown", dtype=object)
    n_illicit = int(n_labeled * illicit_frac)
    labeled_idx = rng.permutation(n)[:n_labeled]
    labels[labeled_idx[:n_illicit]] = "1"
    labels[labeled_idx[n_illicit:]] = "2"
    y = np.where(labels == "1", 0, np.where(labels == "2", 1, rng.integers(0, 2, n)))

    half = n_clusters // 2
    occupied = rng.uniform(size=(n_clusters, N_FEATURES_RAW)) > sparsity
    base_lvl = rng.integers(1, n_levels, size=(n_clusters, N_FEATURES_RAW))
    cls_tilt = np.where(np.arange(n_clusters) < half, tilt, -tilt)[:, None]
    lvl = np.clip(
        np.round(base_lvl + cls_tilt * rng.uniform(size=(n_clusters, N_FEATURES_RAW))),
        0, n_levels)
    protos = np.where(occupied, lvl, 0.0)

    cl = np.where(y == 0, rng.integers(0, half, n), rng.integers(half, n_clusters, n))
    feats = protos[cl].astype(float)
    jit = rng.uniform(size=(n, N_FEATURES_RAW)) < jitter_p
    step = rng.choice([-1.0, 1.0], size=(n, N_FEATURES_RAW))
    feats = np.clip(feats + jit * step, 0, n_levels)

    labeled_mask = labels != "unknown"
    for i in np.where(labeled_mask & (rng.uniform(size=n) < flip))[0]:
        labels[i] = "2" if labels[i] == "1" else "1"

    pathlib.Path(dataset_dir).mkdir(parents=True, exist_ok=True)
    feats = np.round(feats, 6)
    with open(raw, "w", encoding="utf-8") as fh:
        for node, t, row in zip(node_ids, times, feats):
            fh.write(f"{int(node)},{int(t)}," + ",".join(repr(float(v)) for v in row) + "\n")
    with open(pathlib.Path(dataset_dir) / "elliptic_txs_classes.csv", "w",
              encoding="utf-8") as fh:
        for node, label in zip(node_ids, labels):
            fh.write(f"{int(node)},{label}\n")
    prov.write_text(json.dumps(params))
