"""Tabular datasets: a CSV reader, the preprocessing pipeline and the nine
UCI-style loaders (counterpart of ``dib_tpu/data/tabular.py``).

The JAX package reads its files with pandas and scales them with
scikit-learn's ``QuantileTransformer``; the port needs neither, so it keeps
numpy equivalents of the parts it uses:

  - :func:`read_csv` and :class:`Frame`: a header row, a separator, quoted
    fields, empty and NA cells as NaN, and pandas' column types (int64 when
    every cell is an integer, float64 when every cell is a number or NA,
    otherwise strings), with dropping, renaming and row selection;
  - :class:`QuantileTransformer`: scikit-learn's dense fit (``n_quantiles``
    references on ``linspace(0, 1)``, ``nanpercentile`` quantiles, the same
    ``RandomState`` subsample above ``subsample`` rows) and its transform
    (the mean of the forward and backward ``np.interp``, the 1e-7 bounds,
    ``scipy.stats.norm.ppf`` and its clip);
  - :class:`TabularPreprocessor`: one-hot categoricals (categories sorted,
    an unseen one a zero row), the noisy quantile fit, y standardisation.

Each loader reads its file under ``data_path`` when it is there and
otherwise falls back, with a warning, to a synthetic surrogate with planted
feature relevance (``bundle.extras['source']`` says which). Nothing is
downloaded. Each scalar feature is its own bottleneck channel; a one-hot
group is one channel per original categorical column.
"""

from __future__ import annotations

import csv
import os
import warnings
from dataclasses import dataclass

import numpy as np

from dib_tpu_torch.data.registry import DatasetBundle, register_dataset

DATASET_URLS = {
    "mice_protein": "https://archive.ics.uci.edu/ml/machine-learning-databases/00342/Data_Cortex_Nuclear.xls",
    "wine": "https://archive.ics.uci.edu/ml/machine-learning-databases/wine-quality/winequality-red.csv",
    "bikeshare": "https://archive.ics.uci.edu/ml/machine-learning-databases/00275/Bike-Sharing-Dataset.zip",
}

# the cells pandas reads as NaN by default
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
BOUNDS_THRESHOLD = 1e-7     # scikit-learn's quantile-transform bound


class Frame:
    """Named columns of equal length, in order: numbers as float64 or int64
    arrays, anything else as object arrays of ``str`` with NaN for missing
    cells."""

    def __init__(self, columns: dict):
        self.data = {str(name): np.asarray(values) for name, values in columns.items()}

    @property
    def columns(self) -> list[str]:
        return list(self.data)

    def __len__(self) -> int:
        return len(next(iter(self.data.values()))) if self.data else 0

    def __contains__(self, name) -> bool:
        return name in self.data

    def __getitem__(self, name) -> np.ndarray:
        return self.data[name]

    def __setitem__(self, name, values) -> None:
        self.data[name] = np.asarray(values)

    def take(self, rows) -> "Frame":
        return Frame({name: values[rows] for name, values in self.data.items()})

    def drop(self, names) -> "Frame":
        names = set(names)
        return Frame({name: v for name, v in self.data.items() if name not in names})

    def rename(self, mapping: dict) -> "Frame":
        return Frame({mapping.get(name, name): v for name, v in self.data.items()})


def _column(cells: list[str]) -> np.ndarray:
    """One column's cells in pandas' type: int64, float64 (NaN for NA
    cells) or strings."""
    missing = [cell in NA_VALUES for cell in cells]
    present = [cell for cell, na in zip(cells, missing) if not na]
    try:
        ints = [int(cell) for cell in present]
    except ValueError:
        ints = None
    if ints is not None and not any(missing):
        return np.asarray(ints, dtype=np.int64)
    try:
        return np.asarray([np.nan if na else float(cell) for cell, na in zip(cells, missing)],
                          dtype=np.float64)
    except ValueError:
        return np.asarray([np.nan if na else cell for cell, na in zip(cells, missing)],
                          dtype=object)


def read_csv(path: str, sep: str = ",") -> Frame:
    """A CSV file with a header row as a :class:`Frame` (what the JAX
    package's ``pd.read_csv`` gives its loaders): blank lines skipped,
    short rows padded with NaN, an empty header named ``Unnamed: <i>`` and a
    repeated one ``<name>.<k>``."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f, delimiter=sep) if row]
    if not rows:
        raise ValueError(f"{path}: no header row")
    header, body = rows[0], rows[1:]
    names, seen = [], {}
    for i, name in enumerate(header):
        name = name or f"Unnamed: {i}"
        if name in seen:
            seen[name] += 1
            name = f"{name}.{seen[name]}"
        else:
            seen[name] = 0
        names.append(name)
    width = len(names)
    for line, row in enumerate(body, start=2):
        if len(row) > width:
            raise ValueError(f"{path}:{line}: {len(row)} fields, the header has {width}")
    cells = [[row[j] if j < len(row) else "" for row in body] for j in range(width)]
    return Frame({name: _column(col) for name, col in zip(names, cells)})


class QuantileTransformer:
    """scikit-learn's ``QuantileTransformer`` on dense float64 arrays.

    ``fit`` takes ``n_quantiles_ = min(n_quantiles, rows)`` quantiles of
    each column at ``references_ = linspace(0, 1, n_quantiles_)`` with
    ``np.nanpercentile``, from a subsample of ``subsample`` rows (shuffled
    by ``RandomState(random_state)``, as scikit-learn's ``resample``) when
    there are more, and makes them monotone with ``np.maximum.accumulate``
    (a no-op but for rounding; ``np.interp`` needs increasing points).
    ``transform`` maps each column to [0, 1] by the mean of the forward and
    backward interpolation (ties map to the middle of their run), pins
    values within 1e-7 of the ends to 0 and 1, and for ``'normal'`` output
    applies ``scipy.stats.norm.ppf``, clipped where scikit-learn clips it.
    NaN stays NaN.
    """

    def __init__(self, n_quantiles: int = 1000, output_distribution: str = "uniform",
                 subsample: int | None = 10_000, random_state=None):
        if output_distribution not in ("uniform", "normal"):
            raise ValueError(f"Unknown output_distribution {output_distribution!r}")
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.subsample = subsample
        self.random_state = random_state

    def fit(self, x) -> "QuantileTransformer":
        x = np.asarray(x, dtype=np.float64)
        n = x.shape[0]
        self.n_quantiles_ = max(1, min(self.n_quantiles, n))
        self.references_ = np.linspace(0, 1, self.n_quantiles_, endpoint=True)
        if self.subsample is not None and self.subsample < n:
            rows = np.arange(n)
            np.random.RandomState(self.random_state).shuffle(rows)
            x = x[rows[:self.subsample]]
        self.quantiles_ = np.maximum.accumulate(
            np.nanpercentile(x, self.references_ * 100, axis=0))
        return self

    def _transform_col(self, col: np.ndarray, quantiles: np.ndarray) -> np.ndarray:
        refs = self.references_
        with np.errstate(invalid="ignore"):
            if self.output_distribution == "normal":
                low = col - BOUNDS_THRESHOLD < quantiles[0]
                high = col + BOUNDS_THRESHOLD > quantiles[-1]
            else:
                low, high = col == quantiles[0], col == quantiles[-1]
        finite = ~np.isnan(col)
        values = col[finite]
        col[finite] = 0.5 * (np.interp(values, quantiles, refs)
                             - np.interp(-values, -quantiles[::-1], -refs[::-1]))
        col[high] = 1.0
        col[low] = 0.0
        if self.output_distribution == "normal":
            from scipy.stats import norm

            with np.errstate(invalid="ignore"):
                col = norm.ppf(col)
                edge = BOUNDS_THRESHOLD - np.spacing(1)
                col = np.clip(col, norm.ppf(edge), norm.ppf(1 - edge))
        return col

    def transform(self, x) -> np.ndarray:
        out = np.array(x, dtype=np.float64, copy=True)
        for j in range(out.shape[1]):
            out[:, j] = self._transform_col(out[:, j], self.quantiles_[:, j])
        return out


def _categories(values: np.ndarray) -> list:
    """``sorted(pd.unique(values))``."""
    return sorted(set(values.tolist())) if values.dtype == object else sorted(
        np.unique(values).tolist())


@dataclass
class TabularPreprocessor:
    """One-hot categoricals + noisy quantile transform + y standardisation.

    ``quantile_noise`` adds Gaussian noise (std = noise / max(column std,
    noise)) only while FITTING the transformer, so repeated values become
    separable; the transform itself is applied to the clean data. The
    quantile transform covers every encoded column, one-hot columns too.
    """

    random_state: int = 1337
    cat_features: tuple = ()
    y_normalize: bool = False
    quantile_transform: bool = True
    output_distribution: str = "normal"
    n_quantiles: int = 2000
    quantile_noise: float = 1e-3

    def fit(self, x: Frame, y: np.ndarray | None = None):
        self.columns_ = list(x.columns)
        self.cat_maps_ = {col: _categories(x[col]) for col in self.cat_features}
        encoded = self._encode(x)
        self.feature_dimensionalities_ = [
            len(self.cat_maps_[col]) if col in self.cat_maps_ else 1 for col in self.columns_]
        if self.quantile_transform:
            values = encoded.astype(np.float64)
            rng = np.random.RandomState(self.random_state)
            if self.quantile_noise:
                stds = np.std(values, axis=0, keepdims=True)
                noise_std = self.quantile_noise / np.maximum(stds, self.quantile_noise)
                fit_values = values + noise_std * rng.randn(*values.shape)
            else:
                fit_values = values
            self.qt_ = QuantileTransformer(
                random_state=self.random_state,
                n_quantiles=min(self.n_quantiles, len(x)),
                output_distribution=self.output_distribution,
            ).fit(fit_values)
        if y is not None and self.y_normalize:
            self.y_mu_, self.y_std_ = float(np.mean(y)), float(np.std(y))
        else:
            self.y_mu_, self.y_std_ = 0.0, 1.0
        return self

    def _encode(self, x: Frame) -> np.ndarray:
        blocks = []
        for col in self.columns_:
            if col in self.cat_maps_:
                cats = self.cat_maps_[col]
                index = {cat: i for i, cat in enumerate(cats)}
                idx = np.asarray([index.get(v, -1) for v in x[col].tolist()], dtype=np.int64)
                onehot = np.eye(len(cats), dtype=np.float32)[np.clip(idx, 0, len(cats) - 1)]
                onehot[idx < 0] = 0.0
                blocks.append(onehot)
            else:
                blocks.append(np.asarray(x[col], dtype=np.float32)[:, None])
        return np.concatenate(blocks, axis=-1)

    def transform(self, x: Frame, y: np.ndarray | None = None):
        encoded = self._encode(x)
        if self.quantile_transform:
            encoded = self.qt_.transform(encoded.astype(np.float64)).astype(np.float32)
        encoded = encoded.astype(np.float32)
        if y is None:
            return encoded
        y = np.asarray(y, dtype=np.float32)
        if self.y_normalize:
            y = (y - self.y_mu_) / self.y_std_
        return encoded, y


def _split_frame(df: Frame, target: str, seed: int, valid_fraction: float = 0.2):
    idx = np.random.default_rng(seed).permutation(len(df))
    n_valid = int(len(df) * valid_fraction)
    valid, train = df.take(idx[:n_valid]), df.take(idx[n_valid:])
    return (train.drop([target]), train[target], valid.drop([target]), valid[target])


def _bundle_from_frame(df: Frame, target: str, problem: str, cat_features: tuple = (),
                       seed: int = 1337, name: str = "") -> DatasetBundle:
    x_tr_df, y_tr, x_va_df, y_va = _split_frame(df, target, seed)
    prep = TabularPreprocessor(
        random_state=seed,
        cat_features=cat_features,
        y_normalize=(problem == "regression"),
    ).fit(x_tr_df, y_tr)
    x_train, y_train = prep.transform(x_tr_df, y_tr)
    x_valid, y_valid = prep.transform(x_va_df, y_va)
    x_valid_raw = prep._encode(x_va_df)

    if problem == "regression":
        output_dim, loss, info_based, out_act, metrics = 1, "mse", False, None, ("mse",)
        y_train = y_train.reshape(-1, 1)
        y_valid = y_valid.reshape(-1, 1)
    elif problem == "binary":
        output_dim, loss, info_based, out_act, metrics = 1, "bce", True, None, ("accuracy",)
        y_train = y_train.reshape(-1, 1).astype(np.float32)
        y_valid = y_valid.reshape(-1, 1).astype(np.float32)
    else:  # multiclass
        output_dim = int(max(y_tr.max(), y_va.max())) + 1
        loss, info_based, out_act, metrics = "sparse_ce", True, None, ("accuracy",)
        y_train = y_train.astype(np.int32)
        y_valid = y_valid.astype(np.int32)

    return DatasetBundle(
        x_train=x_train,
        y_train=y_train,
        x_valid=x_valid,
        y_valid=y_valid,
        feature_dimensionalities=list(prep.feature_dimensionalities_),
        output_dimensionality=output_dim,
        loss=loss,
        loss_is_info_based=info_based,
        output_activation=out_act,
        metrics=metrics,
        feature_labels=[str(c) for c in prep.columns_],
        x_valid_raw=x_valid_raw,
        extras={"preprocessor": prep, "problem": problem, "name": name},
    )


def _synthetic_frame(num_rows, num_features, problem, seed, num_classes=2, num_cats=0) -> Frame:
    """Schema-faithful synthetic surrogate with planted feature relevance (a
    few strong features, a few weak, the rest noise), so the information
    allocation has a ground truth to find."""
    rng = np.random.default_rng(seed)
    cols = {}
    strengths = np.zeros(num_features)
    strengths[: max(num_features // 4, 1)] = np.linspace(2.0, 0.5, max(num_features // 4, 1))
    signal = np.zeros(num_rows)
    for i in range(num_features):
        col = rng.normal(size=num_rows)
        signal = signal + strengths[i] * col
        cols[f"f{i}"] = col
    for j in range(num_cats):
        cats = rng.integers(0, 4, size=num_rows)
        signal = signal + 0.5 * (cats == 0)
        cols[f"cat{j}"] = cats.astype(str).astype(object)
    if problem == "regression":
        cols["target"] = signal + 0.1 * rng.normal(size=num_rows)
    elif problem == "binary":
        p = 1.0 / (1.0 + np.exp(-signal / max(np.std(signal), 1e-6)))
        cols["target"] = (rng.random(num_rows) < p).astype(np.float64)
    else:
        q = np.quantile(signal, np.linspace(0, 1, num_classes + 1)[1:-1])
        cols["target"] = np.digitize(signal, q).astype(np.int64)
    return Frame(cols)


def _local_or_synthetic(name, data_path, loader, synth_args, problem, cat_features=(), seed=1337):
    try:
        loaded = loader(data_path)
        # a loader may return (frame, categorical column names) when the
        # real file's categorical columns differ from the surrogate's
        if isinstance(loaded, tuple):
            df, cat_features = loaded
        else:
            df = loaded
        source = "real"
    except (FileNotFoundError, RuntimeError):
        # only a missing file falls back: a malformed real file raises
        warnings.warn(
            f"Dataset {name!r} not found under {data_path}; using a synthetic "
            f"schema-faithful surrogate (bundle.extras['source'] == 'synthetic'). "
            f"Download: {DATASET_URLS.get(name, '<see loader>')}",
            stacklevel=3,
        )
        df = _synthetic_frame(**synth_args)
        source = "synthetic"
    bundle = _bundle_from_frame(df, "target", problem, cat_features=cat_features, seed=seed,
                                name=name)
    bundle.extras["source"] = source
    return bundle


def _existing(path: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return path


@register_dataset("wine")
def fetch_wine(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """UCI red wine quality (regression; ``winequality-red.csv``, ``;``-separated)."""
    def load(path):
        df = read_csv(_existing(os.path.join(path, "winequality-red.csv")), sep=";")
        return df.rename({"quality": "target"})

    return _local_or_synthetic(
        "wine", data_path, load,
        dict(num_rows=1599, num_features=11, problem="regression", seed=seed),
        "regression", seed=seed,
    )


@register_dataset("diabetes")
def fetch_diabetes(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """Diabetes disease progression (Efron et al. 2004): 442 patients, 10
    baseline features, regression; ``data/diabetes.csv`` is committed."""
    def load(path):
        return read_csv(_existing(os.path.join(path, "diabetes.csv")))

    return _local_or_synthetic(
        "diabetes", data_path, load,
        dict(num_rows=442, num_features=10, problem="regression", seed=seed),
        "regression", seed=seed,
    )


@register_dataset("breast_cancer")
def fetch_breast_cancer(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """Wisconsin diagnostic breast cancer: 569 tumours, 30 features, binary;
    ``data/breast_cancer.csv`` is committed."""
    def load(path):
        return read_csv(_existing(os.path.join(path, "breast_cancer.csv")))

    return _local_or_synthetic(
        "breast_cancer", data_path, load,
        dict(num_rows=569, num_features=30, problem="binary", seed=seed),
        "binary", seed=seed,
    )


@register_dataset("wine_recognition")
def fetch_wine_recognition(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """Wine recognition (Forina 1991): 178 wines, 13 analyses, 3 cultivars;
    ``data/wine_recognition.csv`` is committed."""
    def load(path):
        return read_csv(_existing(os.path.join(path, "wine_recognition.csv")))

    return _local_or_synthetic(
        "wine_recognition", data_path, load,
        dict(num_rows=178, num_features=13, problem="multiclass", seed=seed, num_classes=3),
        "multiclass", seed=seed,
    )


@register_dataset("bikeshare")
def fetch_bikeshare(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """UCI bike sharing, hourly counts (regression; ``hour.csv``)."""
    def load(path):
        df = read_csv(_existing(os.path.join(path, "hour.csv")))
        df = df.drop([c for c in ("instant", "dteday", "casual", "registered") if c in df])
        return df.rename({"cnt": "target"})

    return _local_or_synthetic(
        "bikeshare", data_path, load,
        dict(num_rows=4096, num_features=12, problem="regression", seed=seed),
        "regression", seed=seed,
    )


@register_dataset("mice_protein")
def fetch_mice_protein(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """77 protein expression levels -> 8 classes, the 3-bit code of
    (genotype, treatment, behaviour); a missing level is filled with its
    class's mean. The UCI file is ``.xls``: the port reads a ``.csv`` export
    of the same sheet, and refuses the ``.xls`` (no Excel reader)."""
    def load(path):
        f_csv = os.path.join(path, "mice_protein", "Data_Cortex_Nuclear.csv")
        f_xls = os.path.join(path, "mice_protein", "Data_Cortex_Nuclear.xls")
        if not os.path.exists(f_csv):
            if os.path.exists(f_xls):
                raise ValueError(f"{f_xls}: the port reads no Excel files; export the sheet "
                                 f"as {f_csv}")
            raise FileNotFoundError(f_csv)
        raw = read_csv(f_csv)
        proteins = raw.columns[1:78]
        target = ((raw["Genotype"] == "Control").astype(np.int64)
                  + 2 * (raw["Treatment"] == "Memantine").astype(np.int64)
                  + 4 * (raw["Behavior"] == "C/S").astype(np.int64))
        df = Frame({})
        for name in proteins:
            col = np.asarray(raw[name], dtype=np.float64).copy()
            for label in np.unique(target):
                rows = target == label
                gap = rows & np.isnan(col)
                if gap.any():
                    with warnings.catch_warnings():
                        warnings.simplefilter("ignore", RuntimeWarning)   # an all-NaN class
                        col[gap] = np.nanmean(col[rows])
            df[name] = col
        df["target"] = target
        return df

    return _local_or_synthetic(
        "mice_protein", data_path, load,
        dict(num_rows=1080, num_features=77, problem="multiclass", seed=seed, num_classes=8),
        "multiclass", seed=seed,
    )


@register_dataset("credit")
def fetch_credit(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """Credit default (binary; ``credit/data.csv``, the last column the label)."""
    def load(path):
        df = read_csv(_existing(os.path.join(path, "credit", "data.csv")))
        return df.rename({df.columns[-1]: "target"})

    return _local_or_synthetic(
        "credit", data_path, load,
        dict(num_rows=4096, num_features=10, problem="binary", seed=seed),
        "binary", seed=seed,
    )


SUPPORT2_NUMERIC = (
    "age", "slos", "num.co", "edu", "scoma", "avtisst", "sps", "aps",
    "surv2m", "surv6m", "hday", "diabetes", "dementia", "meanbp",
    "wblc", "hrt", "resp", "temp", "pafi", "alb", "bili", "crea",
    "sod", "ph", "glucose", "bun", "urine", "adlsc",
)
SUPPORT2_CATEGORICAL = ("sex", "dzgroup", "dzclass", "race", "ca", "income")


@register_dataset("support2")
def fetch_support2(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """The Vanderbilt SUPPORT2 export (``support2/support2.csv``; binary,
    ``death``): physiological and severity scores as numbers (a missing one
    is its column's median), demographic and diagnostic strings as
    categories (a missing one is ``"missing"``), outcome columns dropped."""
    def load(path):
        raw = read_csv(_existing(os.path.join(path, "support2", "support2.csv")))
        numeric = [c for c in SUPPORT2_NUMERIC if c in raw]
        cats = [c for c in SUPPORT2_CATEGORICAL if c in raw]
        df = Frame({})
        for name in numeric:
            col = raw[name]
            if np.issubdtype(col.dtype, np.floating) and np.isnan(col).any():
                col = np.where(np.isnan(col), np.nanmedian(col), col)
            df[name] = col
        for name in cats:
            col = raw[name]
            if col.dtype == object:
                col = np.asarray(["missing" if isinstance(v, float) and np.isnan(v) else v
                                  for v in col.tolist()], dtype=object)
            df[name] = col
        df["target"] = raw["death"]
        return df, tuple(cats)

    return _local_or_synthetic(
        "support2", data_path, load,
        dict(num_rows=4096, num_features=20, problem="binary", seed=seed, num_cats=2),
        "binary", cat_features=("cat0", "cat1"), seed=seed,
    )


@register_dataset("microsoft")
def fetch_microsoft(data_path: str = "./data/", seed: int = 1337, **_) -> DatasetBundle:
    """Microsoft learning-to-rank relevance (regression; ``microsoft/train.csv``,
    the first column the label)."""
    def load(path):
        df = read_csv(_existing(os.path.join(path, "microsoft", "train.csv")))
        return df.rename({df.columns[0]: "target"})

    return _local_or_synthetic(
        "microsoft", data_path, load,
        dict(num_rows=8192, num_features=16, problem="regression", seed=seed),
        "regression", seed=seed,
    )
