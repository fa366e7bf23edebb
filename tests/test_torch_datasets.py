"""The port's datasets against the JAX package's: the tabular datasets with
their CSV reader and quantile transform, the double pendulum, the radial
shells and the exact truth-table informations.

Tolerances: the numpy quantile transform against scikit-learn's 1e-6; the
tabular bundles 1e-6 on every array, labels, dims, names and loss exact;
radial-shell features bit for bit; the pendulum's RK4 from the same initial
conditions over 200 steps 1e-4 of each state's norm (XLA's sin and cos
differ from torch's by an ulp, and the system is chaotic), its energy 1e-6
of the energy and the unrolled angles exact; a bundle read from one cache
file equal; the exact informations equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.preprocessing import QuantileTransformer as SkQuantileTransformer

import dib_tpu.data as jax_data
import dib_tpu.data.pendulum as jax_pendulum
import dib_tpu_torch.data as port_data
import dib_tpu_torch.data.pendulum as port_pendulum
from dib_tpu_torch.data import tabular
from dib_tpu_torch.ops import entropy as port_entropy

torch.set_num_threads(1)

TOL = 1e-6
REAL_CSVS = ("diabetes", "breast_cancer", "wine_recognition")
SYNTHETIC = ("wine", "bikeshare", "mice_protein", "credit", "support2", "microsoft")
DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

pytestmark = pytest.mark.filterwarnings("ignore::UserWarning")


def assert_same_bundle(got, want, tol=TOL):
    for name in ("x_train", "y_train", "x_valid", "y_valid", "x_valid_raw"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)
    assert list(got.feature_dimensionalities) == list(want.feature_dimensionalities)
    assert list(got.feature_labels) == list(want.feature_labels)
    assert (got.loss, got.loss_is_info_based, got.output_dimensionality) == (
        want.loss, want.loss_is_info_based, want.output_dimensionality)
    assert tuple(got.metrics) == tuple(want.metrics)
    for key in ("source", "problem", "name"):
        assert got.extras.get(key) == want.extras.get(key), key


# ------------------------------------------------------------ quantiles

def _columns(kind, rng):
    if kind == "ties":
        return rng.integers(0, 4, size=(300, 3)).astype(np.float64)
    if kind == "constant":
        return np.concatenate([np.full((200, 1), 2.5), rng.normal(size=(200, 2))], axis=1)
    if kind == "few rows":
        return rng.normal(size=(17, 4))
    if kind == "subsampled":
        return rng.standard_t(3, size=(12_000, 2))
    if kind == "nan":
        x = rng.normal(size=(150, 2))
        x[rng.random(150) < 0.1, 0] = np.nan
        return x
    raise ValueError(kind)


@pytest.mark.parametrize("output", ["normal", "uniform"])
@pytest.mark.parametrize("kind", ["ties", "constant", "few rows", "subsampled", "nan"])
def test_quantile_transform_matches_scikit_learn(kind, output):
    rng = np.random.default_rng(3)
    fit, new = _columns(kind, rng), _columns(kind, np.random.default_rng(4))
    n_quantiles = min(2000, len(fit))
    ours = tabular.QuantileTransformer(n_quantiles=n_quantiles, output_distribution=output,
                                       random_state=1337).fit(fit)
    theirs = SkQuantileTransformer(n_quantiles=n_quantiles, output_distribution=output,
                                   random_state=1337).fit(fit)
    np.testing.assert_allclose(ours.quantiles_, theirs.quantiles_, rtol=0, atol=TOL)
    for x in (fit, new):
        np.testing.assert_allclose(ours.transform(x), theirs.transform(x), rtol=0, atol=TOL)


# ------------------------------------------------------------ the reader

def test_read_csv_types_quotes_and_missing_cells(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text('a;b;c;d;;c\n1;2.5;"x; y";;7;1\n3;;z;NA;8;2\n\n4;1e3;"q ""r""";5;9;3\n')
    frame = tabular.read_csv(str(path), sep=";")
    assert frame.columns == ["a", "b", "c", "d", "Unnamed: 4", "c.1"]
    assert frame["a"].dtype == np.int64 and frame["a"].tolist() == [1, 3, 4]
    np.testing.assert_array_equal(frame["b"], [2.5, np.nan, 1000.0])
    assert frame["c"].tolist() == ["x; y", "z", 'q "r"']
    np.testing.assert_array_equal(frame["d"], [np.nan, np.nan, 5.0])
    renamed = frame.drop(["a"]).rename({"b": "target"}).take(np.array([2, 0]))
    assert renamed.columns[0] == "target" and renamed["c.1"].tolist() == [3, 1]


# ------------------------------------------------------------ tabular bundles

@pytest.mark.parametrize("name", REAL_CSVS + SYNTHETIC)
def test_tabular_bundle_matches_jax(name, tmp_path):
    path = DATA if name in REAL_CSVS else str(tmp_path)
    got = port_data.get_dataset(name, data_path=path)
    want = jax_data.get_dataset(name, data_path=path)
    assert got.extras["source"] == ("real" if name in REAL_CSVS else "synthetic")
    assert_same_bundle(got, want)


def _write(path, header, rows, sep=","):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(sep.join(header) + "\n")
        for row in rows:
            f.write(sep.join(row) + "\n")


def _num(rng, missing=0.0):
    return "" if rng.random() < missing else f"{rng.normal():.6f}"


def _real_files(root, rng):
    """Tiny files in each real loader's layout."""
    n = 48
    _write(os.path.join(root, "winequality-red.csv"),
           ["fixed acidity", "pH", "alcohol", "quality"],
           [[_num(rng), _num(rng), _num(rng), str(rng.integers(3, 9))] for _ in range(n)],
           sep=";")
    _write(os.path.join(root, "hour.csv"),
           ["instant", "dteday", "season", "temp", "casual", "registered", "cnt"],
           [[str(i), f"2011-01-{1 + i % 28:02d}", str(rng.integers(1, 5)), _num(rng),
             str(rng.integers(0, 9)), str(rng.integers(0, 9)), str(rng.integers(1, 99))]
            for i in range(n)])
    proteins = [f"P{k}_N" for k in range(77)]
    _write(os.path.join(root, "mice_protein", "Data_Cortex_Nuclear.csv"),
           ["MouseID", *proteins, "Genotype", "Treatment", "Behavior", "class"],
           [[f"m{i}", *(_num(rng, 0.05) for _ in proteins),
             ("Control", "Ts65Dn")[i % 2], ("Memantine", "Saline")[(i // 2) % 2],
             ("C/S", "S/C")[(i // 4) % 2], "c"] for i in range(n)])
    _write(os.path.join(root, "credit", "data.csv"),
           ["limit", "age", "bill", "default"],
           [[_num(rng), str(rng.integers(20, 70)), _num(rng), str(rng.integers(0, 2))]
            for _ in range(n)])
    _write(os.path.join(root, "support2", "support2.csv"),
           ["age", "death", "sex", "num.co", "dzgroup", "meanbp", "race", "income", "hospdead"],
           [[_num(rng), str(rng.integers(0, 2)), ("male", "female")[rng.integers(0, 2)],
             str(rng.integers(0, 5)), f'"{("ARF/MOSF w/Sepsis", "CHF", "Cirrhosis")[i % 3]}"',
             _num(rng, 0.2), ("white", "black", "")[rng.integers(0, 3)],
             ("", "under $11k", "$11-$25k")[rng.integers(0, 3)], "0"] for i in range(n)])
    _write(os.path.join(root, "microsoft", "train.csv"),
           ["relevance", *(f"f{k}" for k in range(5))],
           [[str(rng.integers(0, 5)), *(_num(rng) for _ in range(5))] for _ in range(n)])


@pytest.mark.parametrize("name", SYNTHETIC)
def test_real_file_loader_matches_jax(name, tmp_path):
    _real_files(str(tmp_path), np.random.default_rng(7))
    got = port_data.get_dataset(name, data_path=str(tmp_path))
    want = jax_data.get_dataset(name, data_path=str(tmp_path))
    assert got.extras["source"] == want.extras["source"] == "real"
    assert_same_bundle(got, want)


def test_mice_protein_refuses_the_excel_file(tmp_path):
    os.makedirs(tmp_path / "mice_protein")
    (tmp_path / "mice_protein" / "Data_Cortex_Nuclear.xls").write_bytes(b"\xd0\xcf")
    with pytest.raises(ValueError, match="Data_Cortex_Nuclear.csv"):
        port_data.get_dataset("mice_protein", data_path=str(tmp_path))


# ------------------------------------------------------------ radial shells

def test_radial_shell_features_match_jax_bit_for_bit():
    got = port_data.get_dataset("amorphous_radial_shells", num_synthetic_neighborhoods=64,
                                num_shells=6, max_radius=7.0, seed=3)
    want = jax_data.get_dataset("amorphous_radial_shells", num_synthetic_neighborhoods=64,
                                num_shells=6, max_radius=7.0, seed=3)
    for name in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    np.testing.assert_array_equal(got.extras["shell_edges"], want.extras["shell_edges"])
    assert got.feature_labels == want.feature_labels
    assert list(got.feature_dimensionalities) == list(want.feature_dimensionalities)


# ------------------------------------------------------------ the pendulum

@pytest.fixture(scope="module")
def initial_conditions():
    y0, valid = jax_pendulum._sample_initial_conditions(jax.random.key(1), 48)
    return np.array(y0), np.array(valid)


def test_rk4_matches_jax_over_200_steps(initial_conditions):
    y0, _ = initial_conditions
    want = np.asarray(jax_pendulum._integrate_batch(jnp.asarray(y0), 1e-2, 200, 2))
    got = port_pendulum._integrate_batch(torch.from_numpy(y0), 1e-2, 200, 2).numpy()
    assert got.shape == want.shape == (48, 100, 4)
    rel = np.linalg.norm(got - want, axis=-1) / np.linalg.norm(want, axis=-1)
    assert rel.max() <= 1e-4


def test_energy_and_unrolled_angles_match_jax(initial_conditions):
    y0, _ = initial_conditions
    states = np.asarray(jax_pendulum._integrate_batch(jnp.asarray(y0), 1e-2, 40, 2))
    want = np.asarray(jax_pendulum.total_energy(states))
    got = port_pendulum.total_energy(torch.from_numpy(states)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    np.testing.assert_array_equal(port_pendulum.unroll_angles(states),
                                  jax_pendulum.unroll_angles(states))


def test_initial_conditions_sit_at_the_target_energy():
    y0, valid = port_pendulum._sample_initial_conditions(torch.Generator().manual_seed(0), 512)
    energy = port_pendulum.total_energy(y0[valid])
    assert 0.2 < valid.float().mean() < 0.8
    torch.testing.assert_close(energy, torch.full_like(energy, 9.81), rtol=1e-5, atol=1e-5)


def test_simulation_keeps_the_round_rule_whatever_the_pass_size(monkeypatch):
    """The rounds' verdicts walk one candidate stream: integrating it in
    passes of one block or of three gives the same data, every kept
    trajectory within the drift tolerance."""
    kwargs = dict(num_trajectories=6, initial_time=0.2, simulation_time=0.4, seed=2,
                  fractional_energy_drift_tol=3e-8, device="cpu")
    monkeypatch.setattr(port_pendulum, "BLOCKS_PER_PASS", 1)
    one = port_pendulum.simulate_double_pendulum(**kwargs)
    monkeypatch.setattr(port_pendulum, "BLOCKS_PER_PASS", 3)
    three = port_pendulum.simulate_double_pendulum(**kwargs)
    assert one.shape == (6, 20, 4)
    np.testing.assert_array_equal(one, three)


def test_pendulum_bundle_from_a_jax_cache_matches_jax(tmp_path):
    trajectories = np.random.default_rng(0).normal(size=(20, 130, 4)).astype(np.float32)
    np.save(tmp_path / "double_pendulum_n20_s5.npy", trajectories)
    kwargs = dict(data_path=str(tmp_path), num_trajectories=20, seed=5, pendulum_time_delta=0.5)
    got = port_data.get_dataset("double_pendulum", device="cpu", **kwargs)
    want = jax_data.get_dataset("double_pendulum", **kwargs)
    assert got.extras["cache"] == str(tmp_path / "double_pendulum_n20_s5.npy")
    for name in ("x_train", "y_train", "x_valid", "y_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert (got.feature_dimensionalities, got.feature_labels, got.loss) == (
        want.feature_dimensionalities, want.feature_labels, want.loss)
    assert got.output_dimensionality == want.output_dimensionality == 6
    assert port_data.registry.dataset_loss("double_pendulum") == got.loss


def test_pendulum_cache_rules(tmp_path, monkeypatch):
    """The legacy file is read for seed 0 and a matching count only; a
    simulation is cached under the port's own name, never the JAX one's."""
    legacy = np.zeros((10, 120, 4), np.float32)
    np.save(tmp_path / "double_pendulum.npy", legacy)
    paths = port_pendulum.cache_paths(str(tmp_path), 10, 0)
    assert port_pendulum._cached(paths, 10, 0) == paths["legacy"]
    assert port_pendulum._cached(port_pendulum.cache_paths(str(tmp_path), 12, 0), 12, 0) is None
    assert port_pendulum._cached(port_pendulum.cache_paths(str(tmp_path), 10, 1), 10, 1) is None
    simulated = np.ones((10, 120, 4), np.float32)
    monkeypatch.setattr(port_pendulum, "simulate_double_pendulum", lambda **_: simulated)
    bundle = port_pendulum.fetch_double_pendulum(str(tmp_path), num_trajectories=10, seed=1,
                                                 pendulum_time_delta=0.2, device="cpu")
    assert bundle.extras["cache"] == str(tmp_path / "double_pendulum_torch_n10_s1.npy")
    np.testing.assert_array_equal(np.load(bundle.extras["cache"]), simulated)
    assert not os.path.exists(tmp_path / "double_pendulum_n10_s1.npy")
    again = port_pendulum.fetch_double_pendulum(str(tmp_path), num_trajectories=10, seed=1,
                                                pendulum_time_delta=0.2, device="cpu")
    np.testing.assert_array_equal(again.x_train, bundle.x_train)


# ------------------------------------------------------------ exact informations

def test_exact_subset_informations_and_entropies_match_jax():
    from dib_tpu.data.boolean_circuit import exact_subset_informations as jax_subsets
    from dib_tpu.ops import entropy as jax_entropy

    circuit = port_data.random_circuit(6, np.random.default_rng(4))
    table = port_data.full_truth_table(circuit)
    got = port_data.exact_subset_informations(table, 6)
    assert got == jax_subsets(table, 6)
    a, b = table[:, :3], table[:, -1]
    assert port_entropy.joint_entropy_bits(a, b) == jax_entropy.joint_entropy_bits(a, b)
    assert port_entropy.mutual_information_bits(a, b) == jax_entropy.mutual_information_bits(a, b)
    np.testing.assert_array_equal(port_entropy.nats_to_bits([1.0, 2.0]),
                                  jax_entropy.nats_to_bits([1.0, 2.0]))


def test_the_registry_holds_every_jax_dataset():
    assert port_data.registry.available_datasets() == jax_data.available_datasets()
