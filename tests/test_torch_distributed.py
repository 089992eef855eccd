"""The port's multi-process path: `parallel.distributed.initialize` over a
real 2-process localhost rendezvous (Gloo on the CPU), the population mesh
over both processes, one collective through it, and a sharded argmax whose
gather is an all_gather (tests/test_distributed.py's counterpart)."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)

    import bayesian_optimization_tpu_torch as tbo
    from bayesian_optimization_tpu_torch.parallel import distributed, shard_population

    addr, rank = sys.argv[1], int(sys.argv[2])
    ok = distributed.initialize(coordinator_address=addr, num_processes=2, process_id=rank)
    assert ok, "initialize() returned False for a 2-process run"
    assert dist.get_world_size() == 2, dist.get_world_size()

    # one real cross-process collective through the population mesh
    mesh = distributed.population_mesh()
    pop = shard_population(torch.ones(mesh.size), mesh)
    total = sum(c.sum() for c in pop.chunks)
    dist.all_reduce(total)
    assert float(total) == float(mesh.size), float(total)

    # a sharded CMA argmax: each rank runs its chains, the gather is an
    # all_gather, and both ranks return the same winner
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (12, 2))
    y = ((X - 0.3) ** 2).sum(1)
    gp = tbo.GaussianProcess(mean=tbo.constant_trend(2), corr="matern", thetaL=1e-3 * np.ones(2),
                             thetaU=1e3 * np.ones(2), nugget=1e-6, random_start=2, max_iter=10,
                             random_state=0, device="cpu")
    gp.fit(X, (y - y.mean()) / y.std())
    opt = tbo.AcquisitionArgmax(tbo.RealSpace([[0.0, 1.0]] * 2).encoding(),
                                method="OnePlusOne_Cholesky_CMA", n_chains=6, max_FEs=96, seed=0,
                                mesh=mesh, device="cpu")
    u, v = opt(gp.posterior, gp.config, "EI", {"plugin": float(((y - y.mean()) / y.std()).min())})
    print(json.dumps({
        "rank": dist.get_rank(), "world": dist.get_world_size(),
        "primary": distributed.is_primary(), "mesh": mesh.size, "local": list(mesh.local),
        "gathers": mesh.gathers, "u": u.tolist(), "v": v,
    }))
    dist.destroy_process_group()
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_initialize_and_collective(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("sockets unavailable on this host")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("BO_TPU_WORLD", None)
    env.pop("BO_TPU_RANK", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), f"127.0.0.1:{port}", str(rank)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True,
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=150)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.skip("the rendezvous timed out on this host")
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout={out}\nstderr={err}"
    infos = sorted((json.loads(out.strip().splitlines()[-1]) for _, out, _ in outs),
                   key=lambda d: d["rank"])
    assert [d["rank"] for d in infos] == [0, 1]
    assert all(d["world"] == 2 and d["mesh"] == 2 for d in infos)
    assert infos[0]["primary"] and not infos[1]["primary"]
    assert [d["local"] for d in infos] == [[0], [1]]  # each rank owns its own rows
    assert all(d["gathers"] == 1 for d in infos)
    assert infos[0]["u"] == infos[1]["u"] and infos[0]["v"] == infos[1]["v"]


def test_initialize_noop_single_process(monkeypatch):
    from bayesian_optimization_tpu_torch.parallel import distributed

    monkeypatch.delenv("BO_TPU_WORLD", raising=False)
    assert distributed.initialize() is False
    assert distributed.is_primary()
