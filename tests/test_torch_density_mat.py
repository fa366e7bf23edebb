"""The port's log-density matrix and blocked row statistics vs the JAX
package, on the same numpy-seeded inputs.

On the CPU ``log_density_matrix`` takes its plain PyTorch version; it is held
to the JAX package's Pallas kernel run in interpret mode, at the shapes and
tolerances of ``tests/test_pallas_density.py``: 2e-5, and 1e-6 on the
diagonal at small variance (u ~= mu, where the norm expansion would cancel).
``mi_row_stats_blocked`` is held to ``_mi_row_stats_xla`` at 2e-5. The CUDA
kernel itself runs only on the card and is tested in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dib_tpu.ops.info_bounds import _mi_row_stats_xla
from dib_tpu.ops.pallas_density import gaussian_log_density_mat_pallas
from dib_tpu_torch.ops import density, info_bounds

torch.set_num_threads(1)

F32_TOL = 2e-5
DIAG_TOL = 1e-6


def random_params(rng, n, m, d):
    u = rng.normal(scale=2.0, size=(n, d)).astype(np.float32)
    mus = rng.normal(scale=2.0, size=(m, d)).astype(np.float32)
    logvars = rng.normal(scale=0.7, size=(m, d)).astype(np.float32) - 1.0
    return u, mus, logvars


@pytest.mark.parametrize("n,m,d,bm,bn", [
    (64, 64, 8, 32, 32),       # exact tiling
    (50, 70, 12, 32, 32),      # both axes ragged
    (8, 8, 4, 128, 128),       # one tile larger than the problem
    (130, 33, 16, 64, 32),     # ragged rows and columns
    (40, 24, 100, 32, 32),     # a channel axis wider than the card kernel's ring stage
])
def test_density_matrix_matches_pallas_kernel(rng, n, m, d, bm, bn):
    u, mus, logvars = random_params(rng, n, m, d)
    want = gaussian_log_density_mat_pallas(jnp.asarray(u), jnp.asarray(mus),
                                           jnp.asarray(logvars), block_rows=bm,
                                           block_cols=bn, interpret=True)
    before = density.log_density_mat_launches
    got = density.log_density_matrix(*map(torch.from_numpy, (u, mus, logvars)))
    assert density.log_density_mat_launches == before     # the plain version counts nothing
    assert got.shape == (n, m) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)


def test_density_matrix_keeps_the_diagonal_precise(rng):
    n, d = 96, 16
    mus = rng.normal(scale=3.0, size=(n, d)).astype(np.float32)
    logvars = np.full((n, d), -6.0, dtype=np.float32)
    u = mus + rng.normal(scale=np.exp(-3.0), size=(n, d)).astype(np.float32)
    want = gaussian_log_density_mat_pallas(jnp.asarray(u), jnp.asarray(mus),
                                           jnp.asarray(logvars), block_rows=32,
                                           block_cols=32, interpret=True)
    got = density.log_density_matrix(*map(torch.from_numpy, (u, mus, logvars)))
    np.testing.assert_allclose(np.diag(got.numpy()), np.diag(np.asarray(want)),
                               rtol=DIAG_TOL, atol=DIAG_TOL)


@pytest.mark.parametrize("n,d,row_block", [
    (50, 8, 16),       # ragged last block (50 = 3 x 16 + 2)
    (64, 4, 32),       # whole blocks
    (40, 6, None),     # the whole matrix at once
])
def test_blocked_row_stats_match_jax(rng, n, d, row_block):
    u, mus, logvars = random_params(rng, n, n, d)
    want = _mi_row_stats_xla(jnp.asarray(u), jnp.asarray(mus), jnp.asarray(logvars),
                             row_block)
    got = info_bounds.mi_row_stats_blocked(*map(torch.from_numpy, (u, mus, logvars)),
                                           row_block=row_block)
    for g, w in zip(got, want):
        assert g.shape == (n,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL)
    # the blocks see only rows: the statistics equal the one-pass plain version's
    for g, w in zip(got, density.mi_row_stats_reference(
            *map(torch.from_numpy, (u, mus, logvars)))):
        torch.testing.assert_close(g, w, rtol=F32_TOL, atol=F32_TOL)


def test_wrappers_reject_what_they_cannot_take():
    u = torch.zeros(5, 3)
    with pytest.raises(ValueError, match=r"u \[N,d\]"):
        density.log_density_matrix(u[None], u, u)
    with pytest.raises(ValueError, match=r"u \[N,d\]"):
        density.log_density_matrix(u, u, u[:4])
    with pytest.raises(ValueError, match="channel axes differ"):
        density.log_density_matrix(u, torch.zeros(5, 4), torch.zeros(5, 4))
    with pytest.raises(ValueError, match="one device"):
        density.log_density_matrix(u, u.to("meta"), u)
    with pytest.raises(ValueError, match="cpu or cuda"):
        density.log_density_matrix(u.to("meta"), u.to("meta"), u.to("meta"))
    with pytest.raises(ValueError, match="row_block"):
        info_bounds.mi_row_stats_blocked(u, u, u, row_block=0)
