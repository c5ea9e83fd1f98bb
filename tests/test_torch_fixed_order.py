"""``se2lam_tpu_torch.ops.fixed_order``: the sums a fleet's ``torch.vmap``
takes on the card, in an order fixed by one robot's shapes.

On the CPU the public helpers are the plain forms, bitwise, batched or not
(the parity tests against JAX hold those bits). The fixed-order forms that
the card takes under a vmap are tested here directly: each equals its
plain form within f32 rounding (atol stated per case, from the size of the
sums), and gives a batch element the same bits at every batch size.
"""
import numpy as np
import pytest
import torch

from se2lam_tpu_torch.ops import fixed_order as fo

torch.set_num_threads(2)


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32))


FORMS = {
    # name: (fixed form, plain form, inputs of one batch element, atol)
    "sum_halving": (fo._sum_halving, lambda x: x.sum(-1), lambda: (_rand(1000) * 300,), 5e-3),
    "matmul_rows": (fo._matmul_rows, lambda a, b: a @ b,
                    lambda: (_rand(128, 9, 8), _rand(128, 8, 9, seed=1)), 1e-5),
    "rows_matvec": (fo.rows_matvec, lambda M, v: torch.einsum("tij,tj->ti", M, v),
                    lambda: (_rand(128, 3, 3), _rand(128, 3, seed=1)), 1e-6),
    "rows_vecmat": (fo.rows_vecmat, lambda u, M: torch.einsum("ti,tij->tj", u, M),
                    lambda: (_rand(128, 3, seed=1), _rand(128, 3, 3)), 1e-6),
}


@pytest.mark.parametrize("name", sorted(FORMS))
def test_fixed_form_matches_plain_and_ignores_batch_size(name):
    fixed, plain, make, atol = FORMS[name]
    args = make()
    want = fixed(*args)
    np.testing.assert_allclose(want.numpy(), plain(*args).numpy(), rtol=0, atol=atol)
    for B in (1, 3, 8):
        others = [[a + 0.5 * _rand(*a.shape, seed=10 + b) for a in args] for b in range(B - 1)]
        batch = [torch.stack([a] + [o[i] for o in others]) for i, a in enumerate(args)]
        assert torch.equal(torch.vmap(fixed)(*batch)[0], want), B


@pytest.mark.parametrize("batched", [False, True])
def test_helpers_are_the_plain_forms_on_the_cpu(batched):
    x, A = _rand(1000, 2), _rand(128, 8, 9)
    M, v = _rand(128, 3, 3), _rand(128, 3, seed=1)

    def helpers(x, A, M, v):
        return (fo.sum_points(x, 0), fo.sum_points(x[:, 0]), fo.matmul(A.transpose(-1, -2), A),
                fo.contract("tij,tj->ti", M, v, fo.rows_matvec),
                fo.contract("ti,tij->tj", v, M, fo.rows_vecmat))

    def plain(x, A, M, v):
        return (x.sum(0), x[:, 0].sum(), A.transpose(-1, -2) @ A,
                torch.einsum("tij,tj->ti", M, v), torch.einsum("ti,tij->tj", v, M))

    if batched:
        args = [torch.stack([a, a + 1]) for a in (x, A, M, v)]
        got, want = torch.vmap(helpers)(*args), torch.vmap(plain)(*args)
    else:
        got, want = helpers(x, A, M, v), plain(x, A, M, v)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_index_add_helpers():
    """On the CPU ``index_add(_)`` is ``index_add_``, bitwise; the card's
    ``segment_sum`` adds each index's values in their input order, which
    runs here too, and sorts an index tensor once."""
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 40, (500,), generator=g, dtype=torch.int32)
    vals = torch.randn(500, 3, generator=g)
    base = torch.randn(40, 3, generator=g)
    want = base.clone().index_add_(0, idx, vals)
    assert torch.equal(fo.index_add(base, idx, vals), want)
    assert torch.equal(fo.index_add_(base.clone(), idx, vals), want)
    seq = torch.zeros(40, 3)
    for i, v in zip(idx.tolist(), vals):
        seq[i] += v
    assert torch.equal(fo.segment_sum(idx, vals, 40), seq)
    perm = fo._segments(idx, 40)[0]
    assert fo._segments(idx, 40)[0] is perm
    idx[0] = 39 - idx[0]            # a write to the indices sorts them again
    assert fo._segments(idx, 40)[0] is not perm
