"""Remote ask/tell optimization service over HTTP/JSON.

Counterpart of bayesian_optimization_tpu/service/http_server.py: the same
JSON protocol, job registry and built-in dashboard, with the port's `BO`,
`ParallelBO` and `MOBO` behind it, built on the device the server was
started with (`--device`, default "cuda"; nothing falls back to the CPU):

- POST {"search_param": {...}, "bo_param": {...}}   -> {"job_id": id}
- GET  ?ask=null&job_id=id                          -> {"job_id", "X": [dict, ...]}
- POST {"job_id": id, "X": [...], "y": [...]}       -> {"job_id", "iteration"}
- GET  ?finalize=null&job_id=id                     -> {"job_id", "finalized": true}
- GET  ?recommend=null&job_id=id                    -> {"xopt", "fopt"}
- GET  ?status=null[&job_id=id]                     -> monitoring JSON
- GET  /                                            -> the dashboard

Implementation: stdlib ThreadingHTTPServer; one optimizer per job keyed by
a random id; jobs are independent, so requests for different jobs proceed
concurrently (a per-job lock serializes ask/tell). An exception becomes an
error reply carrying "error" (404 unknown job, 400 bad request, 500 else).
Nothing here touches the GPU before a job is created, so `main` can
daemonize (fork) first: a CUDA context made before a fork is unusable in
the child.
"""
from __future__ import annotations

import argparse
import json
import os
import secrets
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .._device import DEFAULT_DEVICE, resolve_device


class Job:
    def __init__(self, optimizer, max_iter: int):
        self.optimizer = optimizer
        self.max_iter = max_iter
        self.iteration = 0
        self.lock = threading.Lock()
        self.pending = None  # candidates awaiting a tell


def _build_optimizer(search_param: dict, bo_param: dict, device=DEFAULT_DEVICE):
    from ..core.bo import BO, ParallelBO
    from ..core.mobo import MOBO
    from ..space import SearchSpace

    space = SearchSpace.from_dict(search_param)
    n_point = int(bo_param.get("n_point", 1))
    n_obj = int(bo_param.get("n_obj", 1))
    kwargs = dict(
        search_space=space,
        DoE_size=int(bo_param.get("DoE_size", 5)),
        max_FEs=int(bo_param.get("max_iter", 100)) * max(n_point, 1) + int(bo_param.get("DoE_size", 5)),
        n_job=int(bo_param.get("n_job", 1)),
        random_seed=bo_param.get("random_seed"),
        eval_type="dict",
        device=device,
    )
    if n_obj > 1:
        return MOBO(n_obj=n_obj, minimize=bo_param.get("minimize", True), **kwargs)
    kwargs["minimize"] = bool(bo_param.get("minimize", True))
    if n_point > 1:
        return ParallelBO(n_point=n_point, **kwargs)
    return BO(n_point=1, **kwargs)


class OptimizationService:
    """Job registry; the HTTP handler delegates here (also usable in-process).
    Every job's optimizer runs on `device`."""

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = device
        self.jobs: Dict[str, Job] = {}
        self._lock = threading.Lock()

    def create(self, payload: dict) -> dict:
        optimizer = _build_optimizer(payload["search_param"], payload.get("bo_param", {}), self.device)
        job_id = secrets.token_urlsafe(12)
        with self._lock:
            self.jobs[job_id] = Job(optimizer, int(payload.get("bo_param", {}).get("max_iter", 100)))
        return {"job_id": job_id}

    def _job(self, job_id: Optional[str]) -> Job:
        if not job_id or job_id not in self.jobs:
            raise KeyError(f"unknown job_id {job_id!r}")
        return self.jobs[job_id]

    def ask(self, job_id: str) -> dict:
        job = self._job(job_id)
        with job.lock:
            X = job.optimizer.ask()
            job.pending = X
            clean = [
                {k: (v.item() if isinstance(v, np.generic) else v) for k, v in x.items()}
                for x in X
            ]
            return {"job_id": job_id, "X": clean}

    def tell(self, payload: dict) -> dict:
        job = self._job(payload.get("job_id"))
        with job.lock:
            X = payload["X"]
            y = payload["y"]
            job.optimizer.tell(X, y)
            job.iteration += 1
            return {"job_id": payload["job_id"], "iteration": job.iteration}

    def recommend(self, job_id: str) -> dict:
        job = self._job(job_id)
        with job.lock:
            xopt = job.optimizer.recommend()
            return {
                "job_id": job_id,
                "xopt": [dict(zip(job.optimizer.var_names, row)) for row in xopt.tolist()],
                "fopt": np.asarray(xopt.fitness, dtype=float).ravel().tolist(),
            }

    def finalize(self, job_id: str) -> dict:
        with self._lock:
            self.jobs.pop(job_id, None)
        return {"job_id": job_id, "finalized": True}

    def status(self, job_id: Optional[str] = None) -> dict:
        """Monitoring JSON for the dashboard (the reference ships an R-Shiny
        GUI speaking this service's protocol — shiny/USAGE.md; here the GUI
        is built in, served at GET /)."""
        if job_id is None:
            with self._lock:
                ids = list(self.jobs)
            return {"jobs": [self.status(i)["job"] for i in ids]}
        job = self._job(job_id)
        with job.lock:
            opt = job.optimizer
            best: list = []
            for v in opt.hist_f:
                for x in np.ravel(np.asarray(v, dtype=float)):
                    x = float(x)
                    best.append(x if not best else min(best[-1], x))
            try:
                fopt = float(opt.fopt) if opt.eval_count else None
            except Exception:  # noqa: BLE001 - MO has no scalar fopt
                fopt = None
            return {"job": {
                "job_id": job_id,
                "iteration": job.iteration,
                "eval_count": int(opt.eval_count),
                "max_FEs": int(opt.max_FEs) if opt.max_FEs else None,
                "fopt": fopt,
                "best_so_far": best,
            }}


_DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>BO service dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { margin: 24px; font: 14px/1.5 system-ui, sans-serif;
         background: #fcfcfb; color: #0b0b0b;
         --series-1: #2a78d6; --ink-2: #52514e; --grid: #e5e4e0; }
  @media (prefers-color-scheme: dark) {
    body { background: #1a1a19; color: #ffffff;
           --series-1: #3987e5; --ink-2: #c3c2b7; --grid: #3a3936; }
  }
  h1 { font-size: 18px; font-weight: 600; }
  table { border-collapse: collapse; margin: 12px 0 24px; }
  th, td { text-align: left; padding: 4px 14px 4px 0;
           border-bottom: 1px solid var(--grid); }
  th { color: var(--ink-2); font-weight: 500; }
  td.num { font-variant-numeric: tabular-nums; }
  .muted { color: var(--ink-2); }
  svg text { fill: var(--ink-2); font: 11px system-ui, sans-serif; }
  .chart-title { font-size: 13px; color: var(--ink-2); margin: 0 0 4px; }
  #tip { position: fixed; pointer-events: none; background: #0b0b0b; color: #fff;
         padding: 3px 8px; border-radius: 4px; font-size: 12px; display: none; }
</style></head><body>
<h1>Bayesian-optimization service</h1>
<p class="muted">Live ask/tell jobs. Auto-refreshes every 2&nbsp;s.</p>
<div id="jobs"></div><div id="tip"></div>
<script>
const fmt = v => v == null ? "\\u2014" : (Math.abs(v) < 1e-3 || Math.abs(v) >= 1e5
  ? v.toExponential(3) : v.toPrecision(5));
function sparkline(best, jobId) {
  if (!best.length) return '<p class="muted">no evaluations yet</p>';
  const W = 420, H = 120, L = 46, B = 18, T = 8;
  const n = best.length, lo = Math.min(...best), hi = Math.max(...best);
  const span = (hi - lo) || 1;
  const px = i => L + (W - L - 8) * (n === 1 ? 0 : i / (n - 1));
  const py = v => T + (H - T - B) * (1 - (v - lo) / span);
  const pts = best.map((v, i) => px(i) + "," + py(v)).join(" ");
  let grid = "";
  for (const f of [0, 0.5, 1]) {
    const y = T + (H - T - B) * f, v = hi - span * f;
    grid += `<line x1="${L}" y1="${y}" x2="${W-8}" y2="${y}" stroke="var(--grid)"/>` +
            `<text x="${L-6}" y="${y+4}" text-anchor="end">${fmt(v)}</text>`;
  }
  return `<p class="chart-title">best objective so far vs iterations</p>
  <svg width="${W}" height="${H}" data-job="${jobId}" data-best="${best.join(',')}">
    ${grid}
    <text x="${L}" y="${H-2}">iter 1</text><text x="${W-8}" y="${H-2}" text-anchor="end">${n}</text>
    <polyline points="${pts}" fill="none" stroke="var(--series-1)" stroke-width="2"/>
    <circle cx="${px(n-1)}" cy="${py(best[n-1])}" r="4" fill="var(--series-1)"/>
    <circle id="hover-${jobId}" r="4" fill="var(--series-1)" stroke="#fcfcfb"
            stroke-width="2" style="display:none"/>
  </svg>`;
}
function hover(e) {
  const svg = e.currentTarget, tip = document.getElementById("tip");
  const best = svg.dataset.best.split(",").map(Number);
  const r = svg.getBoundingClientRect();
  const L = 46, W = 420, n = best.length;
  const i = Math.max(0, Math.min(n - 1,
    Math.round((e.clientX - r.left - L) / ((W - L - 8) / Math.max(n - 1, 1)))));
  const dot = svg.querySelector('circle[id^="hover-"]');
  const lo = Math.min(...best), hi = Math.max(...best), span = (hi - lo) || 1;
  dot.style.display = "";
  dot.setAttribute("cx", L + (W - L - 8) * (n === 1 ? 0 : i / (n - 1)));
  dot.setAttribute("cy", 8 + (120 - 8 - 18) * (1 - (best[i] - lo) / span));
  tip.style.display = "block";
  tip.style.left = (e.clientX + 12) + "px"; tip.style.top = (e.clientY - 24) + "px";
  tip.textContent = "iter " + (i + 1) + ": " + fmt(best[i]);
}
function unhover(e) {
  document.getElementById("tip").style.display = "none";
  const dot = e.currentTarget.querySelector('circle[id^="hover-"]');
  if (dot) dot.style.display = "none";
}
async function refresh() {
  try {
    const r = await fetch("?status=null");
    const data = await r.json();
    const el = document.getElementById("jobs");
    if (!data.jobs.length) { el.innerHTML = '<p class="muted">no active jobs</p>'; return; }
    el.innerHTML = data.jobs.map(j => `
      <table><tr><th>job</th><th>iterations</th><th>evaluations</th>
        <th>budget</th><th>best f</th></tr>
      <tr><td>${j.job_id}</td><td class="num">${j.iteration}</td>
        <td class="num">${j.eval_count}</td><td class="num">${j.max_FEs ?? "\\u2014"}</td>
        <td class="num">${fmt(j.fopt)}</td></tr></table>
      ${sparkline(j.best_so_far, j.job_id)}`).join("<hr style='border:none'>");
    el.querySelectorAll("svg").forEach(s => {
      s.addEventListener("mousemove", hover); s.addEventListener("mouseleave", unhover);
    });
  } catch (err) { /* server restarting; retry on next tick */ }
}
refresh(); setInterval(refresh, 2000);
</script></body></html>
"""


def make_handler(service: OptimizationService, verbose: bool = False):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            if verbose:
                super().log_message(fmt, *args)

        def _send(self, obj, code: int = 200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, exc: Exception, code: int = 400):
            self._send({"error": type(exc).__name__, "message": str(exc)}, code)

        def _send_html(self, html: str, code: int = 200):
            body = html.encode()
            self.send_response(code)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            parsed = urlparse(self.path)
            q = parse_qs(parsed.query)
            job_id = (q.get("job_id") or [None])[0]
            try:
                if "ask" in q:
                    self._send(service.ask(job_id))
                elif "finalize" in q:
                    self._send(service.finalize(job_id))
                elif "recommend" in q:
                    self._send(service.recommend(job_id))
                elif "status" in q:
                    self._send(service.status(job_id))
                elif parsed.path in ("/", "/dashboard") and not q:
                    self._send_html(_DASHBOARD_HTML)
                else:
                    self._send({"status": "ok", "jobs": len(service.jobs)})
            except KeyError as e:
                self._error(e, 404)
            except Exception as e:  # noqa: BLE001 - report to client
                self._error(e, 500)

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                if "search_param" in payload:
                    self._send(service.create(payload))
                elif "y" in payload:
                    self._send(service.tell(payload))
                else:
                    raise ValueError("POST body must contain 'search_param' (create) or 'y' (tell)")
            except (ValueError, KeyError) as e:
                self._error(e, 400)
            except Exception as e:  # noqa: BLE001
                self._error(e, 500)

    return Handler


def serve(port: int = 7200, host: str = "127.0.0.1", verbose: bool = False,
          device=DEFAULT_DEVICE) -> ThreadingHTTPServer:
    """The server (not yet serving) whose jobs run on `device`; a CUDA
    device without a usable GPU raises here."""
    resolve_device(device)
    service = OptimizationService(device)
    server = ThreadingHTTPServer((host, port), make_handler(service, verbose))
    server.service = service
    return server


def pidfile_for(port: int) -> str:
    """The pidfile `main -d` writes for a port, in the temporary directory."""
    return os.path.join(tempfile.gettempdir(), f"bo_torch_http_{port}.pid")


def main(argv=None):
    parser = argparse.ArgumentParser(description="bayesian_optimization_tpu_torch ask/tell HTTP service")
    parser.add_argument("-w", "--port", type=int, default=7200)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-d", "--daemon", action="store_true", help="detach via double fork")
    parser.add_argument("--device", default=DEFAULT_DEVICE, help="device of every job (default cuda)")
    args = parser.parse_args(argv)
    if args.daemon:  # before anything touches the GPU
        from .daemon import daemonize

        daemonize(pidfile=pidfile_for(args.port))
    server = serve(args.port, args.host, args.verbose, args.device)
    print(f"serving ask/tell on http://{args.host}:{args.port} (device {args.device})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
