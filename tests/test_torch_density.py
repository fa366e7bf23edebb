"""The MI-sandwich row statistics and bounds of the PyTorch port vs the JAX
package, on the same numpy-seeded inputs.

On the CPU ``mi_row_stats`` takes its plain PyTorch version; it is held to
the JAX package's Pallas kernel run in interpret mode, at the shapes of
``tests/test_pallas_density.py``, at 2e-5 (2e-2 for bfloat16 inputs, whose
rounding the two frameworks do at different places). The CUDA kernel itself
runs only on the card and is tested in ``tests/test_torch_cuda.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.ops.gaussian import reparameterize as jax_reparameterize
from dib_tpu.ops.info_bounds import mi_sandwich_bounds as jax_bounds
from dib_tpu.ops.info_bounds import mi_sandwich_from_params as jax_from_params
from dib_tpu.ops.info_bounds import mi_sandwich_probe as jax_probe
from dib_tpu.ops.pallas_density import mi_row_stats_pallas
from dib_tpu_torch.ops import density, info_bounds

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2e-2
BOUNDS_TOL = 1e-5


def random_params(rng, n, m, d):
    u = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    mus = rng.normal(scale=2.0, size=(m, d)).astype(np.float32)
    logvars = rng.normal(scale=0.7, size=(m, d)).astype(np.float32) - 1.0
    return u, mus, logvars


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a, np.float32)) for a in arrays)


@pytest.mark.parametrize("n,d,bm,bn", [
    (64, 8, 32, 32),
    (50, 12, 32, 32),
    (130, 16, 64, 32),
    (8, 4, 128, 128),
    (1, 4, 128, 128),      # N = 1: the off-diagonal row is all masked
])
def test_row_stats_match_pallas_kernel(rng, n, d, bm, bn):
    u, mus, logvars = random_params(rng, n, n, d)
    want = mi_row_stats_pallas(jnp.asarray(u), jnp.asarray(mus), jnp.asarray(logvars),
                               block_rows=bm, block_cols=bn, interpret=True)
    got = density.mi_row_stats(*_torch(u, mus, logvars))
    for g, w in zip(got, want):
        assert g.shape == (n,) and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)
    if n == 1:
        assert got[2].item() == np.float32(density.NEG_INF)


def test_row_stats_probe_mode_matches_pallas_kernel(rng):
    u, mus, logvars = random_params(rng, 30, 70, 8)
    _, want, _ = mi_row_stats_pallas(jnp.asarray(u), jnp.asarray(mus), jnp.asarray(logvars),
                                     block_rows=16, block_cols=32, interpret=True,
                                     diagonal=False)
    full, full2, full3 = density.mi_row_stats(*_torch(u, mus, logvars), diagonal=False)
    assert full.shape == (30,) and torch.equal(full2, full) and torch.equal(full3, full)
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_row_stats_bfloat16_inputs_match_pallas_kernel(rng):
    u, mus, logvars = (jnp.asarray(a, jnp.bfloat16) for a in random_params(rng, 48, 48, 8))
    want = mi_row_stats_pallas(u, mus, logvars, block_rows=32, block_cols=32, interpret=True)
    got = density.mi_row_stats(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16() for a in (u, mus, logvars)))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BF16_TOL, atol=BF16_TOL)


def test_row_stats_group_axis_is_independent_groups(rng):
    groups = [random_params(rng, 20, 20, 6) for _ in range(3)]
    stacked = density.mi_row_stats(*_torch(*(np.stack(a) for a in zip(*groups))))
    for i, group in enumerate(groups):
        single = density.mi_row_stats(*_torch(*group))
        for s, g in zip(stacked, single):
            torch.testing.assert_close(s[i], g, rtol=0, atol=0)


def test_row_stats_rejects_what_it_cannot_take(rng):
    u, mus, logvars = _torch(*random_params(rng, 8, 8, 4))
    with pytest.raises(ValueError, match="N == M"):
        density.mi_row_stats(u[:5], mus, logvars)
    with pytest.raises(ValueError, match="group or channel"):
        density.mi_row_stats(u[:, :3], mus, logvars)
    with pytest.raises(ValueError, match="cpu or cuda"):
        density.mi_row_stats(u.to("meta"), mus.to("meta"), logvars.to("meta"))
    before = density.mi_row_stats_launches
    density.mi_row_stats(u, mus, logvars)
    assert density.mi_row_stats_launches == before   # the plain version never counts


@pytest.mark.parametrize("g,n,m,sm_count,tile,per_sm,want", [
    (400, 1024, 1024, 132, 128, 2, 1),    # the beta sweep's grid fills the card: columns whole
    (50, 1024, 1024, 132, 128, 2, 4),     # the MI hook
    (10, 1024, 1024, 132, 128, 2, 8),     # the MI query: as many ranges as tiles
    (1, 10_000, 512, 132, 128, 2, 4),     # the flagship's probe grid
    (1, 1000, 4096, 132, 128, 2, 32),     # few rows, many columns
    (2, 1, 1, 132, 128, 2, 1),            # one tile cannot split
    (8, 4096, 4096, 8, 128, 2, 1),        # a small card full at once
    (3, 1000, 2000, 16, 128, 2, 8),       # evened: 16 tiles in 8 ranges of 2, not 11 ranges
    (50, 1024, 1024, 132, 64, 2, 3),      # a smaller tile: more row blocks, fewer splits
    (50, 1024, 1024, 132, 128, 1, 3),     # one block per SM: half the target
])
def test_column_splits_fill_the_card_within_the_column_tiles(g, n, m, sm_count, tile, per_sm,
                                                             want):
    splits = density.column_splits(g, n, m, sm_count, tile, per_sm)
    assert splits == want
    tiles = math.ceil(m / tile)
    row_blocks = g * math.ceil(n / tile)
    assert 1 <= splits <= tiles
    assert (splits > 1) == (row_blocks < density.WAVES * per_sm * sm_count and tiles > 1)
    per_range = math.ceil(tiles / splits)
    assert (splits - 1) * per_range < tiles      # no range is left empty


def test_sandwich_from_params_matches_jax(rng):
    """Same draw (the JAX key's u injected): InfoNCE lower and LOO upper,
    the LOO bound at /B with the diagonal excluded."""
    _, mus, logvars = random_params(rng, 96, 96, 8)
    key = jax.random.key(3)
    want = jax_from_params(key, jnp.asarray(mus), jnp.asarray(logvars))
    u = jax_reparameterize(key, jnp.asarray(mus), jnp.asarray(logvars))
    got = info_bounds.mi_sandwich_from_params(*_torch(mus, logvars), u=_torch(u)[0])
    np.testing.assert_allclose([g.item() for g in got], [float(w) for w in want],
                               rtol=BOUNDS_TOL, atol=BOUNDS_TOL)
    assert got[0].item() <= got[1].item()


def test_sandwich_probe_matches_jax(rng):
    pm, dm, dl = random_params(rng, 40, 120, 8)
    pl = (np.random.default_rng(7).normal(size=(40, 8)) * 0.4 - 1.0).astype(np.float32)
    u = rng.normal(size=(40, 8)).astype(np.float32) * 0.3 + pm
    want = jax_probe(jax.random.key(5), jnp.asarray(pm), jnp.asarray(pl), jnp.asarray(dm),
                     jnp.asarray(dl), u=jnp.asarray(u))
    got = info_bounds.mi_sandwich_probe(*_torch(pm, pl, dm, dl), u=_torch(u)[0])
    for g, w in zip(got, want):
        assert g.shape == (40,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BOUNDS_TOL, atol=BOUNDS_TOL)


def test_sandwich_bounds_replaying_jax_draws_match_jax(rng):
    """mi_sandwich_bounds with the JAX key schedule's batch indices and noise
    injected gives the JAX averages."""
    data = rng.normal(size=(50, 3)).astype(np.float32)
    w = rng.normal(size=(3, 8)).astype(np.float32)

    def jax_encode(x):
        return x @ jnp.asarray(w), jnp.tanh(x @ jnp.asarray(w)) - 1.0

    def torch_encode(x):
        return x @ torch.from_numpy(w), torch.tanh(x @ torch.from_numpy(w)) - 1.0

    key, batch, batches = jax.random.key(11), 16, 3
    want = jax_bounds(jax_encode, jnp.asarray(data), key, batch, batches)
    idx, us = [], []
    for k in jax.random.split(key, batches):
        k_idx, k_noise = jax.random.split(k)
        rows = jax.random.randint(k_idx, (batch,), 0, data.shape[0])
        mus, logvars = jax_encode(jnp.asarray(data)[rows])
        idx.append(np.asarray(rows))
        us.append(np.asarray(jax_reparameterize(k_noise, mus, logvars)))
    got = info_bounds.mi_sandwich_bounds(
        torch_encode, torch.from_numpy(data), evaluation_batch_size=batch,
        number_evaluation_batches=batches, idx=torch.from_numpy(np.stack(idx)),
        u=torch.from_numpy(np.stack(us)))
    np.testing.assert_allclose([g.item() for g in got], [float(v) for v in want],
                               rtol=BOUNDS_TOL, atol=BOUNDS_TOL)
