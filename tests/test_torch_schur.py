"""The Schur point reduction (kernel K3's plain version and the
``schur_reduce`` wrapper) against the JAX package's einsum route and its
Pallas kernel in interpret mode, on random SPD point blocks.

Tolerance: max|S − S_ref| / max|S_ref| ≤ 1e-5, the JAX package's own
kernel tolerance (``tests/test_pallas_schur.py``): the two sides sum the
same f32 products in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.solver import ba as jba
from se2lam_tpu.solver.pallas_schur import schur_reduce_pallas
from se2lam_tpu_torch.solver import schur

torch.set_num_threads(2)

SHAPES = [(4, 12), (8, 130), (24, 512)]


def _inputs(rng, K, M):
    Hpx = rng.normal(0, 1, (K, 3, M, 3)).astype(np.float32)
    L = rng.normal(0, 1, (M, 3, 3)).astype(np.float32)
    Hxx = L @ np.swapaxes(L, -1, -2) + np.eye(3, dtype=np.float32)
    Hxx_inv = np.linalg.inv(Hxx).astype(np.float32)
    Hpp = rng.normal(0, 1, (K, K, 3, 3)).astype(np.float32)
    bp = rng.normal(0, 1, (K, 3)).astype(np.float32)
    bx = rng.normal(0, 1, (M, 3)).astype(np.float32)
    return Hpp, bp, Hpx, Hxx_inv, bx


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("K,M", SHAPES)
def test_plain_reduction_matches_jax_einsum_and_pallas(rng, K, M):
    _, _, Hpx, Hxx_inv, _ = _inputs(rng, K, M)
    got = schur.point_reduction_plain(torch.from_numpy(Hpx), torch.from_numpy(Hxx_inv))
    T = jnp.einsum("kamb,mbc->kamc", Hpx, Hxx_inv)
    want = jnp.einsum("kamb,lcmb->klac", T, Hpx)
    assert got.shape == (K, K, 3, 3)
    assert _rel(got.numpy(), want) <= 1e-5
    pallas = schur_reduce_pallas(jnp.asarray(Hpx), jnp.asarray(Hxx_inv), interpret=True)
    assert _rel(got.numpy(), pallas) <= 1e-5


@pytest.mark.parametrize("K,M", SHAPES)
def test_schur_reduce_matches_jax(rng, K, M):
    Hpp, bp, Hpx, Hxx_inv, bx = _inputs(rng, K, M)
    S, b = schur.schur_reduce(*(torch.from_numpy(a) for a in (Hpp, bp, Hpx, Hxx_inv, bx)))
    S_want, b_want = jba.schur_reduce(*(jnp.asarray(a) for a in (Hpp, bp, Hpx, Hxx_inv, bx)))
    assert _rel(S.numpy(), S_want) <= 1e-5
    assert _rel(b.numpy(), b_want) <= 1e-5


def test_zeroed_point_columns_add_nothing(rng):
    """Invalid points (zeroed coupling columns) contribute exact zeros."""
    K, M = 6, 40
    Hpx = rng.normal(0, 1, (K, 3, M, 3)).astype(np.float32)
    Hpx[:, :, M // 2:] = 0.0
    Hxx_inv = np.broadcast_to(np.eye(3, dtype=np.float32), (M, 3, 3)).copy()
    full = schur.point_reduction(torch.from_numpy(Hpx), torch.from_numpy(Hxx_inv))
    half = schur.point_reduction(torch.from_numpy(Hpx[:, :, : M // 2].copy()),
                                 torch.from_numpy(Hxx_inv[: M // 2].copy()))
    np.testing.assert_allclose(full.numpy(), half.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_tensor_runs_the_plain_version(rng):
    """A CPU tensor never reaches the kernel: the launch count stays."""
    _, _, Hpx, Hxx_inv, _ = _inputs(rng, 4, 12)
    before = schur.point_reduction.launches
    got = schur.point_reduction(torch.from_numpy(Hpx), torch.from_numpy(Hxx_inv))
    want = schur.point_reduction_plain(torch.from_numpy(Hpx), torch.from_numpy(Hxx_inv))
    assert schur.point_reduction.launches == before
    assert torch.equal(got, want)
