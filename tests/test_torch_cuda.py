"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test here is marked ``cuda`` and skips without a CUDA device: the
kernels have no CPU mode. The file imports nothing of JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: 2e-5 for float32 inputs, 2e-2 for bfloat16 inputs (the JAX
package's Pallas tolerances); the kernels accumulate in float32 in another
order than the plain versions. The density matrix's diagonal at small
variance: 1e-6, as the JAX package holds its Pallas kernel. Attention
scores scaled by 100 and gradients: 1e-4, as the JAX package's flash tests
hold them, and 2e-2 for bfloat16 inputs; probe bounds 1e-4 nats.
"""

import math

import pytest
import torch

from dib_tpu_torch.ops import attention, density, info_bounds

F32_TOL = 2e-5
BF16_TOL = 2e-2
GRAD_TOL = 1e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, g, n, m, d, diagonal, lv_range=None):
    gen = torch.Generator(device=device).manual_seed(0)
    mus = 2.0 * torch.randn(g, m, d, generator=gen, device=device)
    if lv_range is None:
        logvars = 0.7 * torch.randn(g, m, d, generator=gen, device=device) - 1.0
    else:
        low, high = lv_range
        logvars = low + (high - low) * torch.rand(g, m, d, generator=gen, device=device)
    if diagonal:   # u near its own row's mean: the diagonal-dominant regime
        u = mus + torch.randn(g, m, d, generator=gen, device=device) * torch.exp(0.5 * logvars)
    else:
        u = 2.0 * torch.randn(g, n, d, generator=gen, device=device)
    return u, mus, logvars


def _plain(u, mus, logvars, diagonal, groups=25):
    """The plain version, ``groups`` groups at a time (it forms [G, N, M, d])."""
    parts = [density.mi_row_stats_reference(u[i:i + groups], mus[i:i + groups],
                                            logvars[i:i + groups], diagonal=diagonal)
             for i in range(0, u.shape[0], groups)]
    return tuple(torch.cat([p[k] for p in parts]) for k in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("g,n,m,d,dtype,diagonal", [
    (10, 1024, 1024, 32, torch.float32, True),     # the slice's shape
    (3, 1000, 1000, 37, torch.float32, True),      # ragged rows, columns and d
    (2, 1, 1, 32, torch.float32, True),            # N = 1: off-diagonal all masked
    (1, 70, 70, 64, torch.float32, True),          # widest supported channel
    (4, 256, 256, 32, torch.bfloat16, True),
    (1, 2000, 512, 32, torch.float32, False),      # probe mode, M != N
    (400, 1024, 1024, 32, torch.float32, True),    # the beta sweep's grid: columns whole
    (1, 1000, 4096, 32, torch.float32, False),     # probe mode, columns split 32 ways
    (3, 2, 2, 32, torch.float32, True),            # the diagonal on a tile's edges
    (3, 33, 33, 32, torch.float32, True),
    (4, 300, 300, 64, torch.float32, True),        # widest channel, columns split
    (20, 1024, 1024, 8, torch.float32, True),      # the radial shells' channels
    (1, 64, 64, 8, torch.float32, True),           # the characterization's smallest batch
    (77, 1024, 1024, 32, torch.float32, True),     # mice_protein's 77 channels
])
def test_kernel_matches_plain_version_on_card(cuda_device, g, n, m, d, dtype, diagonal):
    u, mus, logvars = (t.to(dtype) for t in _inputs(cuda_device, g, n, m, d, diagonal))
    before = density.mi_row_stats_launches
    got = density.mi_row_stats(u, mus, logvars, diagonal=diagonal)
    torch.cuda.synchronize()
    assert density.mi_row_stats_launches == before + 1
    want = _plain(u, mus, logvars, diagonal)
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (g, n)
        torch.testing.assert_close(a, b, rtol=tol, atol=tol)
    if n == 1:
        assert bool((got[2] == density.NEG_INF).all())


@pytest.mark.cuda
def test_kernel_holds_the_boolean_workloads_binary_channels_on_card(cuda_device):
    """The boolean workload's channels at the start: d = 1, mu = +-1 and
    logvar -3, so every row is nearly one-hot (the full table, F = 10)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mus = 2.0 * torch.randint(0, 2, (10, 1024, 1), generator=gen, device=cuda_device) - 1.0
    logvars = torch.full_like(mus, -3.0)
    u = mus + torch.randn(mus.shape, generator=gen, device=cuda_device) * math.exp(-1.5)
    got = density.mi_row_stats(u, mus, logvars)
    want = _plain(u, mus, logvars, True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("diagonal", [True, False])
def test_kernel_keeps_the_direct_difference_at_extreme_logvars_on_card(cuda_device, diagonal):
    """Log-variances across -26..20, the untrained flagship's range: entries
    reach |log p| ~ 1e12 while the diagonal stays O(1)."""
    u, mus, logvars = _inputs(cuda_device, 4, 1024, 1024, 32, diagonal, lv_range=(-26.0, 20.0))
    got = density.mi_row_stats(u, mus, logvars, diagonal=diagonal)
    for a, b in zip(got, _plain(u, mus, logvars, diagonal)):
        torch.testing.assert_close(a, b, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_kernel_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    u, mus, logvars = _inputs(cuda_device, 2, 16, 16, 8, True)
    before = density.mi_row_stats_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        density.mi_row_stats(u.double(), mus.double(), logvars.double())
    with pytest.raises(ValueError, match="contiguous"):
        density.mi_row_stats(u.transpose(1, 2).contiguous().transpose(1, 2), mus, logvars)
    wide = _inputs(cuda_device, 1, 4, 4, density.MAX_DIM + 1, True)
    with pytest.raises(ValueError, match="d <= 64"):
        density.mi_row_stats(*wide)
    assert density.mi_row_stats_launches == before


@pytest.mark.cuda
def test_column_split_defaults_are_the_built_kernels_geometry(cuda_device):
    index = torch.cuda.current_device()
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    for g, n, m in [(10, 1024, 1024), (50, 1024, 1024), (1, 1000, 4096)]:
        assert density.kernel_column_splits(g, n, m, index) == density.column_splits(
            g, n, m, sm_count)


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,d", [
    (1024, 1024, 32),      # a microbench shape
    (1000, 1000, 32),      # ragged rows and columns
    (130, 33, 45),         # ragged everywhere, two chunks of d
    (1, 1, 1),
    (300, 200, 100),       # a channel axis wider than one ring stage
    (64 * 65535 + 1, 3, 1),   # past the old grid's row cap; rows not 16-byte aligned
])
def test_density_matrix_kernel_matches_plain_version_on_card(cuda_device, n, m, d):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    u = 2.0 * torch.randn(n, d, generator=gen, device=cuda_device)
    mus = 2.0 * torch.randn(m, d, generator=gen, device=cuda_device)
    logvars = 0.7 * torch.randn(m, d, generator=gen, device=cuda_device) - 1.0
    before = density.log_density_mat_launches
    got = density.log_density_matrix(u, mus, logvars)
    torch.cuda.synchronize()
    assert density.log_density_mat_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, m)
    torch.testing.assert_close(got, density.gaussian_log_density_mat(u, mus, logvars),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.cuda
def test_density_matrix_kernel_keeps_the_diagonal_precise_on_card(cuda_device):
    """u ~= mu at variance e^-6: the direct difference holds the diagonal to
    1e-6, where the norm expansion would cancel."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    mus = 3.0 * torch.randn(96, 16, generator=gen, device=cuda_device)
    logvars = torch.full((96, 16), -6.0, device=cuda_device)
    u = mus + torch.randn(96, 16, generator=gen, device=cuda_device) * float(torch.exp(
        torch.tensor(-3.0)))
    got = torch.diagonal(density.log_density_matrix(u, mus, logvars))
    want = torch.diagonal(density.gaussian_log_density_mat(u, mus, logvars))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_density_matrix_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    u = torch.randn(8, 4, device=cuda_device)
    before = density.log_density_mat_launches
    with pytest.raises(TypeError, match="float32"):
        density.log_density_matrix(u.double(), u.double(), u.double())
    with pytest.raises(TypeError, match="float32"):
        density.log_density_matrix(u.bfloat16(), u.bfloat16(), u.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        density.log_density_matrix(u.t().contiguous().t(), u, u)
    with pytest.raises(ValueError, match="non-empty"):
        density.log_density_matrix(u[:0], u, u)
    with pytest.raises(ValueError, match="non-empty"):
        density.log_density_matrix(u[:, :0], u[:, :0], u[:, :0])
    assert density.log_density_mat_launches == before


@pytest.mark.cuda
def test_probe_call_at_the_flagship_shape_matches_plain_path_on_card(cuda_device):
    """One probe call of the probe maps: a 100 x 100 grid against a bank of
    512, d = 32, through the probe-mode kernel and through the plain path."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    probe_mus = 2.0 * torch.randn(10_000, 32, generator=gen, device=cuda_device)
    probe_lv = 0.7 * torch.randn(10_000, 32, generator=gen, device=cuda_device) - 1.0
    data_mus = 2.0 * torch.randn(512, 32, generator=gen, device=cuda_device)
    data_lv = 0.7 * torch.randn(512, 32, generator=gen, device=cuda_device) - 1.0
    u = probe_mus + torch.randn(10_000, 32, generator=gen, device=cuda_device) * torch.exp(
        0.5 * probe_lv)
    before = density.mi_row_stats_launches
    got = info_bounds.mi_sandwich_probe(probe_mus, probe_lv, data_mus, data_lv, u=u)
    assert density.mi_row_stats_launches == before + 1
    cpu = [t.cpu() for t in (probe_mus, probe_lv, data_mus, data_lv, u)]
    want = info_bounds.mi_sandwich_probe(*cpu[:4], u=cpu[4])
    for g, w in zip(got, want):
        assert g.shape == (10_000,) and bool(torch.isfinite(g).all())
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


def _qkv(device, batch, seq, heads, dim, dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=device).manual_seed(1)
    q, k, v = (torch.randn(batch, seq, heads, dim, generator=gen, device=device)
               for _ in range(3))
    return (q * scale).to(dtype), (k * scale).to(dtype), v.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,seq,heads,dim,dtype,scale,tol", [
    (32, 50, 12, 128, torch.float32, 1.0, F32_TOL),     # the flagship's shape
    (4, 1024, 12, 128, torch.float32, 1.0, F32_TOL),    # the automatic regime
    (2, 37, 3, 128, torch.float32, 1.0, F32_TOL),       # ragged key and query tiles
    (2, 1, 2, 128, torch.float32, 1.0, F32_TOL),        # one key
    (3, 70, 5, 16, torch.float32, 1.0, F32_TOL),        # narrow heads
    (2, 1024, 4, 128, torch.bfloat16, 1.0, BF16_TOL),
    (2, 64, 3, 128, torch.float32, 100.0, GRAD_TOL),    # huge scores stay finite
    (32, 50, 12, 128, torch.bfloat16, 1.0, BF16_TOL),   # bfloat16: the tensor-core kernel
    (2, 37, 3, 128, torch.bfloat16, 1.0, BF16_TOL),
    (2, 1, 2, 128, torch.bfloat16, 1.0, BF16_TOL),
    (3, 70, 5, 16, torch.bfloat16, 1.0, BF16_TOL),
    (3, 50, 5, 37, torch.bfloat16, 1.0, BF16_TOL),      # D % 8 != 0: synchronous staging
    (3, 50, 5, 37, torch.float32, 1.0, F32_TOL),       # D % 4 != 0: synchronous staging
    (2, 64, 3, 128, torch.bfloat16, 100.0, BF16_TOL),
])
def test_flash_kernel_matches_plain_version_on_card(cuda_device, batch, seq, heads, dim, dtype,
                                                    scale, tol):
    q, k, v = _qkv(cuda_device, batch, seq, heads, dim, dtype, scale)
    before = attention.flash_attention_launches
    got = attention.flash_self_attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.flash_attention_launches == before + 1
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, attention.flash_self_attention_reference(q, k, v),
                               rtol=tol, atol=tol)


def _strided_qkv(device, layout, dtype):
    gen = torch.Generator(device=device).manual_seed(2)
    if layout == "fused":      # q, k, v are strided views of one [B, S, 3, H, D]
        return torch.randn(4, 50, 3, 12, 128, generator=gen, device=device).to(dtype).unbind(2)
    # views that start one element past a 16-byte boundary, with (b, s, h)
    # strides that are not multiples of 4 (8 for bf16): the synchronous staging
    qkv = torch.randn(3, 2, 70, 3, 129, generator=gen, device=device).to(dtype)[..., 1:]
    assert qkv[0].data_ptr() % 16 != 0 and qkv[0].stride(2) == 129
    return qkv.unbind(0)


@pytest.mark.cuda
@pytest.mark.parametrize("layout,dtype,tol", [
    ("fused", torch.float32, F32_TOL),
    ("fused", torch.bfloat16, BF16_TOL),
    ("unaligned", torch.float32, F32_TOL),
    ("unaligned", torch.bfloat16, BF16_TOL),
])
def test_flash_kernel_reads_strided_inputs(cuda_device, layout, dtype, tol):
    q, k, v = _strided_qkv(cuda_device, layout, dtype)
    got = attention.flash_self_attention(q, k, v)
    want = attention.flash_self_attention_reference(q, k, v)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("seq,dtype,tol", [
    (1024, torch.float32, GRAD_TOL),
    (37, torch.float32, GRAD_TOL),
    (1024, torch.bfloat16, BF16_TOL),
])
def test_flash_gradients_match_plain_autograd_on_card(cuda_device, seq, dtype, tol):
    q, k, v = (t.requires_grad_() for t in _qkv(cuda_device, 2, seq, 4, 128, dtype))
    attention.flash_self_attention(q, k, v).square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention.flash_self_attention_reference(q, k, v).square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype
        torch.testing.assert_close(g, t.grad, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 1, 8, 2, 16)
    before = attention.flash_attention_launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        attention.flash_self_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError, match="of one type"):
        attention.flash_self_attention(q, k.bfloat16(), v)
    wide = _qkv(cuda_device, 1, 8, 1, attention.MAX_HEAD_DIM + 1)
    with pytest.raises(ValueError, match="D <= 128"):
        attention.flash_self_attention(*wide)
    strided = q.transpose(1, 3).contiguous().transpose(1, 3)
    with pytest.raises(ValueError, match="unit stride"):
        attention.flash_self_attention(strided, k, v)
    assert attention.flash_attention_launches == before


@pytest.mark.cuda
def test_flash_bf16_at_the_sweep_step_shape_on_card(cuda_device):
    """The north star's bf16 training shape, 8 replicas x 32 sets of 50
    particles (B = 256), 12 heads of 128: the tensor-core kernel's output and
    the blocked-recompute gradients (bfloat16, the input type) against
    autograd through the plain version."""
    q, k, v = (t.requires_grad_() for t in _qkv(cuda_device, 8 * 32, 50, 12, 128, torch.bfloat16))
    before = attention.flash_attention_bf16_launches
    out = attention.flash_self_attention(q, k, v)
    assert attention.flash_attention_bf16_launches == before + 1
    want = attention.flash_self_attention_reference(q, k, v)
    torch.testing.assert_close(out, want, rtol=BF16_TOL, atol=BF16_TOL)
    out.square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    want.square().sum().backward()
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, t.grad, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [None, 8])
def test_bf16_dense_stack_on_card_matches_cpu(cuda_device, stack):
    """A bfloat16 ``MLP`` (a sweep's stack of 8 too) on the card against the
    same layers on the CPU: cuBLAS reduces the bf16 products in float32 (the
    port sets ``allow_bf16_reduced_precision_reduction`` off when it builds a
    bf16 layer) and rounds each product and each bias add to bfloat16, as
    the CPU path does; accumulation order may move a value by an ulp."""
    from dib_tpu_torch.models import MLP

    mlp = MLP(32, (128, 128), 64, "relu", stack=stack, dtype="bfloat16",
              output_dtype="float32", generator=torch.Generator().manual_seed(3))
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction is False
    lead = () if stack is None else (stack,)
    x = torch.randn(lead + (1600, 32), generator=torch.Generator().manual_seed(4))
    want = mlp(x)
    got = mlp.to(cuda_device)(x.to(cuda_device))
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)])
def test_flash_kernel_holds_scores_of_1e8_on_card(cuda_device, dtype, tol):
    """q and k scaled by 1e4 (scaled scores near 1e8, as the untrained
    flagship's block 0 gives them): each row is one-hot, the max key's p is
    exactly 1, and the output is that key's v. An exponent that folds the
    max into an FMA rounds by units there (p off by 2^4)."""
    q, k, v = _qkv(cuda_device, 4, 50, 12, 128, dtype, 1e4)
    got = attention.flash_self_attention(q, k, v)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, attention.flash_self_attention_reference(q, k, v),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_http_server_on_card_matches_the_direct_engine(cuda_device):
    """``DIBServer`` over a model on the card: concurrent HTTP requests of 1
    to 20 rows answer as the direct engine does, within 1e-6 (the batcher
    only pads and splits rows; the forward pass is row-independent)."""
    import json
    import threading
    import urllib.request

    import numpy as np

    from dib_tpu_torch.models import DistributedIBModel
    from dib_tpu_torch.serve import DIBServer, InferenceEngine, ReplicaRouter

    model = DistributedIBModel((1,) * 10, (128, 128), (256, 256), 1, 32, device=cuda_device,
                               generator=torch.Generator().manual_seed(0))
    direct = InferenceEngine(model, batch_buckets=(1, 8), device=cuda_device)
    router = ReplicaRouter.from_params(model, devices=[cuda_device], batch_buckets=(1, 8),
                                       max_batch=8, max_wait_ms=1.0)
    server = DIBServer(router).start()
    rows = np.random.default_rng(0).integers(0, 2, (20, 10)).astype(np.float32)
    answers = {}

    def client(n):
        request = urllib.request.Request(
            server.url + "/v1/predict", data=json.dumps({"x": rows[:n].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(request, timeout=60) as resp:
            answers[n] = json.loads(resp.read())

    try:
        threads = [threading.Thread(target=client, args=(n,)) for n in (1, 3, 8, 20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        server.close()
    want = direct.predict(rows)
    assert sorted(answers) == [1, 3, 8, 20]
    for n, payload in answers.items():
        assert payload["replica"]["device"].startswith("cuda")
        for key in ("prediction", "kl_per_feature"):
            np.testing.assert_allclose(payload[key], want[key][:n], rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_row_stats_on_a_side_stream_equals_the_same_stream(cuda_device):
    """``mi_row_stats`` launched under ``torch.cuda.stream(side)`` (the
    overlapped hooks' path) gives the training stream's result bit for bit,
    its workspace and outputs allocated on the side stream."""
    u, mus, logvars = _inputs(cuda_device, 50, 1024, 1024, 32, True)
    want = density.mi_row_stats(u, mus, logvars)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        got = density.mi_row_stats(u, mus, logvars)
        host = [t.to("cpu", non_blocking=False) for t in got]
    torch.cuda.synchronize(cuda_device)
    for g, w in zip(host, want):
        assert torch.equal(g, w.cpu())


@pytest.mark.cuda
def test_the_overlap_runner_marks_what_the_side_stream_reads(cuda_device):
    """A tensor made on the training stream and read by the side stream is
    freed before the measurement is collected: ``record_stream`` keeps its
    memory from the training stream's next allocations, and the side
    stream's result is that of the same call on the training stream."""
    from dib_tpu_torch.train.overlap import OverlapRunner

    u, mus, logvars = _inputs(cuda_device, 10, 1024, 1024, 32, True)
    want = density.mi_row_stats(u, mus, logvars)[1].cpu()
    runner = OverlapRunner()
    rows = u.clone()
    pending = runner.launch(lambda: (density.mi_row_stats(rows, mus, logvars)[1],),
                            cuda_device, epoch=1, reads=[rows])
    del rows
    scribble = [torch.full_like(u, float("nan")) for _ in range(4)]   # reuse bait
    (got,) = pending.collect()
    assert runner.last_stream != torch.cuda.current_stream(cuda_device)
    assert got.is_pinned() and torch.equal(got, want) and scribble[0].isnan().all()


@pytest.mark.cuda
def test_overlapped_mi_hooks_on_card_equal_the_plain_hooks(cuda_device):
    """``InfoPerFeatureHook(overlap=True)`` through a fit on the card: the
    same bounds and history as ``overlap=False``, its kernels on the side
    stream."""
    from dib_tpu_torch.data import get_dataset
    from dib_tpu_torch.models import DistributedIBModel
    from dib_tpu_torch.train import DIBTrainer, InfoPerFeatureHook, TrainConfig

    bundle = get_dataset("boolean_circuit")
    runs = []
    for overlap in (False, True):
        model = DistributedIBModel(tuple(bundle.feature_dimensionalities), (32,), (64,), 1, 8,
                                   device=cuda_device, generator=torch.Generator().manual_seed(0))
        hook = InfoPerFeatureHook(256, 2, overlap=overlap)
        trainer = DIBTrainer(model, bundle, TrainConfig(batch_size=64, num_pretraining_epochs=1,
                                                        num_annealing_epochs=2,
                                                        steps_per_epoch=4, max_val_points=256),
                             device=cuda_device)
        _, history = trainer.fit(torch.Generator(device=cuda_device).manual_seed(1),
                                 hooks=[hook], hook_every=1)
        runs.append((history, hook.records, hook))
    (plain_history, plain, _), (history, overlapped, hook) = runs
    assert overlapped == plain and len(plain) == 3
    for name in ("loss", "val_loss", "kl_per_feature"):
        assert (getattr(history, name) == getattr(plain_history, name)).all(), name
    assert hook._runner.last_stream is not None
