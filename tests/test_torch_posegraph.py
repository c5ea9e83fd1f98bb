"""The port's pose-graph solver against the JAX package's, on the ring
problems of ``tests/test_posegraph.py`` and the shared
``synthetic_pose_graph`` fixture.

Tolerances: poses within 2e-4 (m, rad) of JAX's after the same LM steps —
both solve the dense 3K×3K system in f32 by pivoted LU, and the
summation order of the scattered blocks differs; chi2 within 1e-4
relative (plus 1e-6 absolute, the converged chi2 is ~1e-5).
"""
import numpy as np
import pytest
import torch

from se2lam_tpu.solver import posegraph as jpg
from se2lam_tpu_torch.convert import pose_graph_from_numpy
from se2lam_tpu_torch.solver import posegraph as tpg

from test_posegraph import ring_problem

torch.set_num_threads(2)


def _both(prob, **kw):
    jp, jinfo = jpg.solve_pose_graph(prob, **kw)
    tp, tinfo = tpg.solve_pose_graph(pose_graph_from_numpy(prob, "cpu"), **kw)
    return np.asarray(jp), jinfo, tp.numpy(), tinfo


@pytest.mark.parametrize("with_loop", [True, False])
@pytest.mark.parametrize("huber", [float("inf"), 3.0])
def test_ring_matches_jax(with_loop, huber):
    prob, gt, est = ring_problem(with_loop=with_loop)
    jp, jinfo, tp, tinfo = _both(prob, iters=15, huber_delta=huber)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-4)
    for k in ("chi2", "chi2_init"):
        np.testing.assert_allclose(float(tinfo[k]), float(jinfo[k]), rtol=1e-4, atol=1e-6)
    if with_loop:
        assert np.linalg.norm(tp[:, :2] - gt[:, :2], axis=1).max() < 0.05
    # the gauge stays exactly where it was
    np.testing.assert_array_equal(tp[0], est[0])


def test_invalid_edges_ignored():
    """Masked-out edges change nothing (``tests/test_posegraph.py``)."""
    import jax.numpy as jnp

    prob, _, _ = ring_problem()
    prob2 = prob._replace(
        edge_i=jnp.concatenate([prob.edge_i, jnp.asarray([3], jnp.int32)]),
        edge_j=jnp.concatenate([prob.edge_j, jnp.asarray([7], jnp.int32)]),
        edge_meas=jnp.concatenate([prob.edge_meas, jnp.asarray([[9.0, 9.0, 2.0]])]),
        edge_info=jnp.concatenate([prob.edge_info, 1e6 * jnp.eye(3)[None]]),
        edge_valid=jnp.concatenate([prob.edge_valid, jnp.asarray([False])]),
    )
    p1, _ = tpg.solve_pose_graph(pose_graph_from_numpy(prob, "cpu"), iters=8)
    p2, _ = tpg.solve_pose_graph(pose_graph_from_numpy(prob2, "cpu"), iters=8)
    np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=0, atol=1e-5)


def test_repeated_edges_accumulate():
    """The same edge twice is one edge at twice the information: the
    scattered blocks add up (JAX's ``.at[].add``)."""
    prob, _, _ = ring_problem()
    import jax.numpy as jnp

    dup = prob._replace(
        edge_i=jnp.concatenate([prob.edge_i, prob.edge_i[-1:]]),
        edge_j=jnp.concatenate([prob.edge_j, prob.edge_j[-1:]]),
        edge_meas=jnp.concatenate([prob.edge_meas, prob.edge_meas[-1:]]),
        edge_info=jnp.concatenate([prob.edge_info, prob.edge_info[-1:]]),
        edge_valid=jnp.concatenate([prob.edge_valid, prob.edge_valid[-1:]]),
    )
    jp, _, tp, _ = _both(dup, iters=10)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=2e-4)


@pytest.mark.parametrize("loops", [dict(loop_pairs=[(0, 39)]), dict(n_random_loops=3)],
                         ids=["explicit", "random"])
def test_synthetic_fixture_and_solve_match_jax(loops):
    jprob = jpg.synthetic_pose_graph(np.random.default_rng(3), 48, **loops)
    tprob = tpg.synthetic_pose_graph(np.random.default_rng(3), 48, **loops, device="cpu")
    for name in jpg.PoseGraphProblem._fields:
        a, b = np.asarray(getattr(jprob, name)), getattr(tprob, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)
    jp, _ = jpg.solve_pose_graph(jprob, iters=15)
    tp, _ = tpg.solve_pose_graph(tprob, iters=15)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=2e-4)
    assert float(tpg.pose_graph_chi2(tprob._replace(poses=tp))) < float(tpg.pose_graph_chi2(tprob))
