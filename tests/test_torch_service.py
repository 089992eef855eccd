"""The port's ask/tell HTTP service end to end over a real socket, with
device="cpu": tests/test_service.py's cases on the port, the JAX
package's service beside it on the same payloads, the daemon, and the
import that must leave CUDA alone (a forked daemon cannot use a CUDA
context made before the fork)."""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from bayesian_optimization_tpu.service.http_server import serve as j_serve
from bayesian_optimization_tpu_torch.service import daemon
from bayesian_optimization_tpu_torch.service.http_server import pidfile_for, serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _run(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    srv = serve(port=0, device="cpu")  # ephemeral port
    yield _run(srv)
    srv.shutdown()


@pytest.fixture(scope="module")
def jax_server():
    srv = j_serve(port=0)
    yield _run(srv)
    srv.shutdown()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url) as r:
        return json.loads(r.read())


MIXED = {
    "search_param": {
        "x": {"type": "r", "range": [-5, 5], "N": 2, "precision": 4},
        "k": {"type": "i", "range": [0, 10], "N": 1},
        "c": {"type": "c", "range": ["a", "b"], "N": 1},
    },
    "bo_param": {"n_point": 1, "max_iter": 10, "DoE_size": 4, "minimize": True, "n_obj": 1, "random_seed": 0},
}


def obj(d):
    return float(d["x0"] ** 2 + d["x1"] ** 2 + d["k"] + (0 if d["c"] == "a" else 1))


def test_full_protocol_roundtrip(server):
    job_id = _post(server, MIXED)["job_id"]
    assert job_id
    for _ in range(2):
        out = _get(f"{server}/?ask=null&job_id={job_id}")
        X = out["X"]
        assert len(X) >= 1 and {"x0", "x1", "k", "c"} <= set(X[0])
        y = [obj(x) for x in X]
        ack = _post(server, {"job_id": job_id, "X": X, "y": y})
        assert ack["iteration"] >= 1

    rec = _get(f"{server}/?recommend=null&job_id={job_id}")
    assert "xopt" in rec and len(rec["fopt"]) == 1

    fin = _get(f"{server}/?finalize=null&job_id={job_id}")
    assert fin["finalized"]


def test_unknown_job_404(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(f"{server}/?ask=null&job_id=nope")
    assert e.value.code == 404


def test_bad_post_400(server):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(server, {"nonsense": 1})
    assert e.value.code == 400


def test_health_endpoint(server):
    out = _get(f"{server}/health")
    assert out["status"] == "ok"


def test_dashboard_html(server):
    with urllib.request.urlopen(f"{server}/") as r:
        assert "text/html" in r.headers["Content-Type"]
        body = r.read().decode()
    assert "Bayesian-optimization service" in body and "?status=null" in body


def test_status_endpoint(server):
    create = {
        "search_param": {"x": {"type": "r", "range": [-5, 5], "N": 2}},
        "bo_param": {"n_point": 1, "max_iter": 5, "DoE_size": 3, "random_seed": 1},
    }
    job_id = _post(server, create)["job_id"]
    st = _get(f"{server}/?status=null&job_id={job_id}")["job"]
    assert st["eval_count"] == 0 and st["best_so_far"] == [] and st["fopt"] is None

    out = _get(f"{server}/?ask=null&job_id={job_id}")
    y = [float(x["x0"] ** 2 + x["x1"] ** 2) for x in out["X"]]
    _post(server, {"job_id": job_id, "X": out["X"], "y": y})

    st = _get(f"{server}/?status=null&job_id={job_id}")["job"]
    assert st["eval_count"] == len(y)
    assert st["fopt"] == pytest.approx(min(y))
    best = st["best_so_far"]  # one point per iteration (hist_f semantics)
    assert best == [pytest.approx(min(y))]
    assert all(a >= b for a, b in zip(best, best[1:]))

    alljobs = _get(f"{server}/?status=null")["jobs"]
    assert any(j["job_id"] == job_id for j in alljobs)
    _get(f"{server}/?finalize=null&job_id={job_id}")


def _seeded(cls, monkeypatch):
    """Give every space a job builds the seed 0: the protocol's random_seed
    reaches the optimizer but not the space, whose LHS draws the DoE, in
    both packages (ROADMAP Queue 3), so an unseeded DoE is drawn from the
    OS's entropy."""
    build = cls.from_dict.__func__

    def from_dict(klass, param):
        space = build(klass, param)
        space.random_seed = 0
        return space

    monkeypatch.setattr(cls, "from_dict", classmethod(from_dict))


@pytest.mark.parametrize("payload", ["mixed", "batch"])
def test_doe_and_recommend_equal_jax_service(server, jax_server, payload, monkeypatch):
    """One create payload with random_seed 0 to both packages' services,
    their spaces seeded alike: the DoE asks are equal, and after the same
    tells so is `recommend`."""
    import bayesian_optimization_tpu.space as j_space
    import bayesian_optimization_tpu_torch.space as t_space

    _seeded(j_space.SearchSpace, monkeypatch)
    _seeded(t_space.SearchSpace, monkeypatch)
    create = MIXED if payload == "mixed" else {
        "search_param": {"x": {"type": "r", "range": [-5, 5], "N": 3}},
        "bo_param": {"n_point": 3, "max_iter": 4, "DoE_size": 6, "random_seed": 0},
    }
    f = obj if payload == "mixed" else (lambda d: float(d["x0"] ** 2 + d["x1"] ** 2 + d["x2"] ** 2))
    ids = [_post(url, create)["job_id"] for url in (server, jax_server)]
    asks = [_get(f"{url}/?ask=null&job_id={i}")["X"] for url, i in zip((server, jax_server), ids)]
    assert asks[0] == asks[1] and len(asks[0]) == create["bo_param"]["DoE_size"]
    y = [f(x) for x in asks[0]]
    for url, i in zip((server, jax_server), ids):
        _post(url, {"job_id": i, "X": asks[0], "y": y})
    recs = [_get(f"{url}/?recommend=null&job_id={i}") for url, i in zip((server, jax_server), ids)]
    assert recs[0]["xopt"] == recs[1]["xopt"] and recs[0]["fopt"] == recs[1]["fopt"] == [min(y)]
    for url, i in zip((server, jax_server), ids):
        _get(f"{url}/?finalize=null&job_id={i}")


def test_cuda_service_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        serve(port=0)


def test_import_leaves_cuda_uninitialized():
    code = ("import torch, bayesian_optimization_tpu_torch.simple_http_server; "
            "import bayesian_optimization_tpu_torch.service.daemon; "
            "print(torch.cuda.is_initialized())")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gone(pid: int) -> bool:
    """Whether pid no longer runs (absent, or a zombie nobody reaped)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_daemon_starts_answers_and_stops():
    try:
        port = _free_port()
    except OSError:
        pytest.skip("sockets unavailable on this host")
    pidfile = pidfile_for(port)
    assert not os.path.exists(pidfile)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launcher = subprocess.run(
        [sys.executable, "-m", "bayesian_optimization_tpu_torch.simple_http_server", "-d",
         "--device", "cpu", "-w", str(port)], env=env, capture_output=True, text=True, timeout=120)
    assert launcher.returncode == 0, launcher.stderr  # the first fork's parent exits at once
    pid = None
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 90
        while True:
            pid = pid or daemon.read_pid(pidfile)
            try:
                health = _get(f"{url}/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the daemon never answered"
                time.sleep(0.2)
        assert health["status"] == "ok"
        pid = daemon.read_pid(pidfile)
        assert pid is not None and daemon.status(pidfile)
        job = _post(url, {"search_param": {"x": {"type": "r", "range": [-1, 1], "N": 2}},
                          "bo_param": {"DoE_size": 3, "random_seed": 0}})
        X = _get(f"{url}/?ask=null&job_id={job['job_id']}")["X"]
        ack = _post(url, {"job_id": job["job_id"], "X": X, "y": [x["x0"] + x["x1"] for x in X]})
        assert "error" not in ack and ack["iteration"] == 1
        assert daemon.stop(pidfile)
        deadline = time.monotonic() + 30
        while not (_gone(pid) and not os.path.exists(pidfile)):
            assert time.monotonic() < deadline, "the daemon outlived SIGTERM"
            time.sleep(0.1)
    finally:
        if pid is not None and not _gone(pid):
            os.kill(pid, signal.SIGKILL)  # this exact pid, never by pattern
        if pid is not None and os.path.exists(pidfile):
            os.remove(pidfile)
