"""The port's edge-sharded pose-graph PCG (``parallel/dist_posegraph.py``)
and the block-tridiagonal factor and solve it preconditions with
(``ops/linalg.py``), against dense solves and the JAX package's, on the
fixtures of ``tests/test_parallel.py``; the port's mesh is n blocks on
the CPU.

Tolerances: the block-tridiagonal solve within 1e-5 of a dense f64 solve
and of JAX's (its scan sums sequentially, the port's scan in log2(K)
levels); the distributed pose graph within 1e-4 of the port's dense solve
and of JAX's distributed one, and chi2 within 1e-3 relative
(``tests/test_parallel.py``); at 12 CG steps the chain-exact
preconditioner within 1e-2 of the dense optimum and 5x closer than
block-Jacobi.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from se2lam_tpu.ops.linalg import block_tridiag_factor as jfactor
from se2lam_tpu.ops.linalg import block_tridiag_solve as jsolve
from se2lam_tpu.parallel import dist_solve_pose_graph as jdist
from se2lam_tpu.parallel import make_mesh as jmesh
from se2lam_tpu_torch.convert import pose_graph_from_numpy
from se2lam_tpu_torch.ops.linalg import block_tridiag_factor, block_tridiag_solve
from se2lam_tpu_torch.parallel import dist_solve_pose_graph, make_mesh
from se2lam_tpu_torch.solver.posegraph import solve_pose_graph

from test_parallel import _make_pose_graph

torch.set_num_threads(2)


def _tridiag_system(rng, K=24, b=3):
    D = np.zeros((K, b, b), np.float32)
    L = np.zeros((K, b, b), np.float32)
    A = np.zeros((K * b, K * b), np.float64)
    for k in range(K):
        Q = rng.normal(size=(b, b))
        D[k] = (Q @ Q.T + 5 * np.eye(b)).astype(np.float32)
        A[k * b:(k + 1) * b, k * b:(k + 1) * b] = D[k]
    for k in range(1, K):
        L[k] = (0.5 * rng.normal(size=(b, b))).astype(np.float32)
        A[k * b:(k + 1) * b, (k - 1) * b:k * b] = L[k]
        A[(k - 1) * b:k * b, k * b:(k + 1) * b] = L[k].T
    r = rng.normal(size=(K, b)).astype(np.float32)
    return D, L, A, r


@pytest.mark.parametrize("K", [1, 24, 37])
def test_block_tridiag_matches_dense_and_jax(K):
    D, L, A, r = _tridiag_system(np.random.default_rng(K), K=K)
    Cinv, Lt = block_tridiag_factor(torch.from_numpy(D), torch.from_numpy(L), eps=0.0)
    x = block_tridiag_solve(Cinv, Lt, torch.from_numpy(r)).numpy()
    np.testing.assert_allclose(x, np.linalg.solve(A, r.reshape(-1)).reshape(K, 3), atol=1e-5)
    jC, jL = jfactor(jnp.asarray(D), jnp.asarray(L), eps=0.0)
    np.testing.assert_allclose(Cinv.numpy(), np.asarray(jC), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x, np.asarray(jsolve(jC, jL, jnp.asarray(r))), atol=1e-5)


@pytest.mark.parametrize("n", [2, 8])
def test_dist_pose_graph_matches_dense_and_jax(n):
    jprob = _make_pose_graph()
    prob = pose_graph_from_numpy(jprob, "cpu")
    p1, info1 = solve_pose_graph(prob, iters=15)
    p2, info2 = dist_solve_pose_graph(prob, make_mesh(n, device="cpu"), iters=15, cg_iters=64)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(info2["chi2"]), float(info1["chi2"]), rtol=1e-3, atol=1e-8)
    jp, _ = jdist(jprob, jmesh(n), iters=15, cg_iters=64)
    np.testing.assert_allclose(p2.numpy(), np.asarray(jp), atol=1e-4)
    # the gauge stays where it was
    np.testing.assert_array_equal(p2[0].numpy(), prob.poses[0].numpy())


@pytest.mark.parametrize("n", [2, 8])
def test_dist_pose_graph_huber_matches_dense(n):
    """With one gross outlier edge the robustified solves agree too."""
    jprob = _make_pose_graph()
    jprob = jprob._replace(edge_meas=jprob.edge_meas.at[-1].add(
        jnp.asarray([1.0, -1.0, 0.5], jnp.float32)))
    prob = pose_graph_from_numpy(jprob, "cpu")
    p1, _ = solve_pose_graph(prob, iters=15, huber_delta=3.0)
    p2, _ = dist_solve_pose_graph(prob, make_mesh(n, device="cpu"), iters=15, cg_iters=64,
                                  huber_delta=3.0)
    np.testing.assert_allclose(p2.numpy(), p1.numpy(), atol=1e-4)


def test_dist_pose_graph_tridiag_beats_jacobi_at_low_cg():
    prob = pose_graph_from_numpy(_make_pose_graph(K=192), "cpu")
    p_ref, _ = solve_pose_graph(prob, iters=15)
    mesh = make_mesh(8, device="cpu")
    p_tri, _ = dist_solve_pose_graph(prob, mesh, iters=15, cg_iters=12, precond="tridiag")
    p_jac, _ = dist_solve_pose_graph(prob, mesh, iters=15, cg_iters=12, precond="jacobi")
    err_tri = float((p_tri - p_ref).abs().max())
    err_jac = float((p_jac - p_ref).abs().max())
    assert err_tri < 1e-2, err_tri
    assert err_tri < 0.2 * err_jac, (err_tri, err_jac)


def test_dist_pose_graph_pads_edges():
    """An edge count the mesh does not divide: padded with invalid edges,
    the same solution as an even split."""
    prob = pose_graph_from_numpy(_make_pose_graph(K=40), "cpu")
    E = prob.edge_i.shape[0]
    assert E % 8
    p8, _ = dist_solve_pose_graph(prob, make_mesh(8, device="cpu"), iters=10, cg_iters=40)
    p1, _ = dist_solve_pose_graph(prob, make_mesh(1, device="cpu"), iters=10, cg_iters=40)
    np.testing.assert_allclose(p8.numpy(), p1.numpy(), atol=1e-5)
