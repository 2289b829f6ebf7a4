"""Prometheus text exposition of the counter and gauge registry
(counterpart of ``poisson_tpu/obs/export.py``).

Two sinks, stdlib only:

- :func:`write_textfile`: one atomic snapshot file, the node-exporter
  ``textfile`` convention for batch runs (``--prom-out``,
  ``POISSON_TPU_PROM_OUT``);
- :func:`start_http_server`: a daemon thread serving ``GET /metrics`` live
  from the registry on 127.0.0.1 (``--metrics-port``,
  ``POISSON_TPU_METRICS_PORT``).

The format is the JAX package's, byte for byte: ``pcg.solves.converged``
becomes ``poisson_tpu_pcg_solves_converged`` (the same prefix, so the same
dashboards read both packages), counters are ``counter``, numeric gauges
``gauge``, a gauge holding percentile keys (``{"p50": …}``) a ``summary``
with ``quantile`` labels, a gauge in the histogram shape (``{"le": {…},
"sum", "count"}``) a ``histogram``, and other gauges a ``# skipped`` line.
:func:`parse_text` reads it back, either package's.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Optional

from poisson_tpu_torch.obs import metrics

_PREFIX = "poisson_tpu_"
_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def metric_name(name: str) -> str:
    """Registry name → Prometheus metric name (sanitized, namespaced)."""
    clean = _SANITIZE.sub("_", name)
    if not clean or not (clean[0].isalpha() or clean[0] == "_"):
        clean = "_" + clean
    return _PREFIX + clean


def _fmt_value(val) -> str:
    if isinstance(val, bool):
        return "1" if val else "0"
    return repr(float(val))


_QUANTILE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")


def _quantile_label(key: str) -> Optional[str]:
    """``p50``/``p99.9`` → ``0.5``/``0.999``; None for other keys."""
    m = _QUANTILE.match(key)
    if not m:
        return None
    return f"{float(m.group(1)) / 100.0:g}"


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _is_histogram_gauge(val) -> bool:
    return (isinstance(val, dict) and set(val) == {"le", "sum", "count"}
            and isinstance(val.get("le"), dict) and val["le"]
            and all(_is_number(v) for v in val["le"].values()))


def _bucket_sort_key(le: str) -> float:
    return float("inf") if le == "+Inf" else float(le)


def render(snapshot: Optional[dict] = None) -> str:
    """The registry (or a given ``metrics.snapshot()``) as exposition text,
    names sorted."""
    snap = snapshot if snapshot is not None else metrics.snapshot()
    lines: list[str] = []
    for kind, bucket in (("counter", snap.get("counters") or {}),
                         ("gauge", snap.get("gauges") or {})):
        for name in sorted(bucket):
            val = bucket[name]
            prom = metric_name(name)
            if kind == "gauge" and _is_histogram_gauge(val):
                lines.append(f"# HELP {prom} poisson_tpu histogram {name}")
                lines.append(f"# TYPE {prom} histogram")
                for le in sorted(val["le"], key=_bucket_sort_key):
                    lines.append(f'{prom}_bucket{{le="{le}"}} '
                                 f"{_fmt_value(val['le'][le])}")
                lines.append(f"{prom}_sum {_fmt_value(val['sum'])}")
                lines.append(f"{prom}_count {_fmt_value(val['count'])}")
                continue
            if (kind == "gauge" and isinstance(val, dict) and val
                    and all(_is_number(v) for v in val.values())
                    and all(_quantile_label(k) for k in val)):
                lines.append(f"# HELP {prom} poisson_tpu summary {name}")
                lines.append(f"# TYPE {prom} summary")
                for key in sorted(val, key=lambda k:
                                  float(_quantile_label(k))):
                    lines.append(
                        f'{prom}{{quantile="{_quantile_label(key)}"}} '
                        f"{_fmt_value(val[key])}")
                continue
            if not isinstance(val, (int, float)):
                lines.append(f"# skipped non-numeric {kind} {name!r}")
                continue
            lines.append(f"# HELP {prom} poisson_tpu {kind} {name}")
            lines.append(f"# TYPE {prom} {kind}")
            lines.append(f"{prom} {_fmt_value(val)}")
    return "\n".join(lines) + "\n"


def parse_text(text: str) -> dict:
    """Exposition text → ``{metric_name: {"type", "value"}}``: the
    read-back half of the round trip (labelled samples keyed by their full
    labelled name, typed by their family's TYPE line)."""
    out: dict[str, dict] = {}
    types: dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split()
            if len(parts) == 2:
                types[parts[0]] = parts[1]
            continue
        if line.startswith("#"):
            continue
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise ValueError(f"unparseable exposition line: {line!r}")
        name, raw = parts
        base = name.partition("{")[0]
        mtype = types.get(base)
        if mtype is None:
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix):
                    mtype = types.get(base[: -len(suffix)])
                    if mtype is not None:
                        break
        out[name] = {"type": mtype, "value": float(raw)}
    return out


def write_textfile(path: str, snapshot: Optional[dict] = None) -> None:
    """Atomically write :func:`render` to ``path``; best effort (a full disk
    never takes the solve down)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            f.write(render(snapshot))
        os.replace(tmp, path)
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass


def start_http_server(port: int = 0, addr: str = "127.0.0.1"):
    """Serve ``GET /metrics`` (and ``/``) from the live registry on a
    daemon thread; returns the server (``server_port`` is the bound port,
    also set as the ``export.http_port`` gauge). Port 0 lets the OS pick.
    Stop it with :func:`stop_http_server`."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class _MetricsHandler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer((addr, int(port)), _MetricsHandler)
    thread = threading.Thread(target=server.serve_forever,
                              name="poisson-tpu-torch-metrics", daemon=True)
    thread.start()
    metrics.gauge("export.http_port", server.server_port)
    return server


def stop_http_server(server) -> None:
    """Shut the endpoint down (idempotent)."""
    if server is None:
        return
    try:
        server.shutdown()
        server.server_close()
    except OSError:
        pass
