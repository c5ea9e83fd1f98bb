"""The port's multi-process runtime on the CPU: two OS processes join one
``torch.distributed`` group over gloo (``parallel.runtime.init_distributed``),
each holding a mesh of 2 CPU blocks, and the mesh's collectives cross the
process boundary (the counterpart of ``tests/test_runtime.py``).

- A psum of ``arange(4n)`` split over the 4 blocks of the 2 processes is
  exact (integers in f32).
- ``dist_solve_pose_graph`` at K = 16 on the 2-process mesh lands within
  5e-3 of ground truth, and its poses are the same on both processes.
- ``global_mesh`` before ``init_distributed`` raises.

torch's CPU build ships gloo, so nothing here skips; the processes have a
time limit of their own.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

_WORKER = textwrap.dedent(
    """
    import sys
    pid, n, port, repo = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    sys.path.insert(0, repo)
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from se2lam_tpu_torch.parallel import runtime
    runtime.init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=n,
                             process_id=pid, device="cpu", blocks_per_device=2)
    assert runtime.is_initialized() and runtime.backend() == "gloo"
    mesh = runtime.global_mesh()
    assert mesh.size == 2 * n and len(mesh.devices) == 2, mesh

    # cross-process psum over the global mesh
    x = torch.arange(4.0 * n)
    total = float(mesh.psum([b.sum() for b in mesh.split(x)])[0])
    expect = float(np.arange(4 * n).sum())
    assert total == expect, (total, expect)

    # the distributed pose-graph solver on the multi-process mesh
    from se2lam_tpu_torch.ops import se2
    from se2lam_tpu_torch.parallel import dist_solve_pose_graph
    from se2lam_tpu_torch.solver.posegraph import PoseGraphProblem

    rng = np.random.default_rng(0)
    K = 16
    gt = np.cumsum(rng.normal(0.1, 0.02, (K, 3)).astype(np.float32), 0)
    g = torch.from_numpy(gt)
    noise = rng.normal(0, 0.03, gt.shape).astype(np.float32)
    noise[0] = 0
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    prob = PoseGraphProblem(
        poses=torch.from_numpy(gt + noise), pose_valid=torch.ones(K, dtype=torch.bool),
        pose_fixed=fixed, edge_i=torch.arange(K - 1, dtype=torch.int32),
        edge_j=torch.arange(1, K, dtype=torch.int32), edge_meas=se2.minus(g[1:], g[:-1]),
        edge_info=(100.0 * torch.eye(3)).expand(K - 1, 3, 3).contiguous(),
        edge_valid=torch.ones(K - 1, dtype=torch.bool))
    poses, info = dist_solve_pose_graph(prob, mesh, iters=8, cg_iters=32)
    err = float((poses - g).abs().max())
    assert err < 5e-3, err
    got = [torch.empty_like(poses) for _ in range(n)]
    torch.distributed.all_gather(got, poses)
    assert all(torch.equal(p, poses) for p in got)
    runtime.shutdown()
    print("OK", pid, total, err, flush=True)
    """
)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_gloo_psum_and_pose_graph(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), "2", str(port), repo],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out in outs:
        assert rc == 0, out[-3000:]
        assert "OK" in out


def test_global_mesh_needs_init():
    from se2lam_tpu_torch.parallel import runtime

    assert not runtime.is_initialized()
    with pytest.raises(RuntimeError, match="init_distributed"):
        runtime.global_mesh()
