"""Kubelet-style HTTP API for the virtual nodes — the `kubectl logs` path.

Reference parity: ListenAndServeSlurmVirtualKubeletServer
(pkg/slurm-virtual-kubelet/virtual-kubelet.go:142-181), which mounts the
virtual-kubelet library's pod routes (AttachPodRoutes — logs/exec) behind
TLS with a restricted cipher list. Routes served here:

- ``GET /containerLogs/{namespace}/{pod}/{container}[?follow=true]`` —
  streams the job's stdout via the provider (TailFile while running with
  follow, OpenFile otherwise), chunked.
- ``GET /stats/summary`` — kubelet stats Summary (node capacity/usage plus
  one entry per pod). The reference declares this surface but ships it
  commented out returning nil (provider.go:324-396); here it is real.
- ``GET /healthz`` — liveness.

Exec/attach/port-forward return 501 like the reference's no-op provider
methods (provider.go:316-398). TLS comes up either from the configured
cert/key files or from a self-signed pair generated in place when they
are missing (tryPrepareTlsCerts, server.go:351 — utils/certs.py).
"""

from __future__ import annotations

import logging
import ssl
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

log = logging.getLogger("sbt.vkhttp")


class VirtualKubeletServer:
    """Serves the kubelet pod routes over all in-process providers.

    ``providers`` is the configurator's live registry (partition →
    VirtualNodeProvider); a pod is looked up in each provider's store —
    the reference runs one server per VK process, this one fronts them all.
    """

    def __init__(
        self,
        providers: dict,
        *,
        address: str = "127.0.0.1",
        port: int = 0,
        tls_cert_file: str = "",
        tls_key_file: str = "",
    ):
        self.providers = providers
        self.address = address
        self.port = port
        self.tls_cert_file = tls_cert_file
        self.tls_key_file = tls_key_file
        self._httpd: ThreadingHTTPServer | None = None

    # -- pod lookup -------------------------------------------------------
    def _find_provider(self, pod_name: str):
        from slurm_bridge_tpu_torch.bridge.objects import Pod

        for provider in list(self.providers.values()):
            try:
                provider.store.get(Pod.KIND, pod_name)
                return provider
            except Exception:
                continue
        return None

    # -- server -----------------------------------------------------------
    def start(self) -> "VirtualKubeletServer":
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _plain(self, status: int, text: str) -> None:
                body = text.encode()
                self.send_response(status)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_POST(self):
                # exec/attach/portforward: explicit 501s (provider.go:316-398)
                self._plain(501, "not implemented\n")

            def do_GET(self):
                url = urlparse(self.path)
                parts = [p for p in url.path.split("/") if p]
                if url.path.startswith("/healthz"):
                    return self._plain(200, "ok")
                if len(parts) == 4 and parts[0] == "containerLogs":
                    _, _ns, pod_name, _container = parts
                    follow = parse_qs(url.query).get("follow", ["false"])[0] == "true"
                    return self._stream_logs(pod_name, follow)
                if parts == ["stats", "summary"]:
                    return self._stats_summary()
                if parts and parts[0] in ("exec", "attach", "portForward", "run"):
                    return self._plain(501, "not implemented\n")
                self._plain(404, "not found\n")

            def _stats_summary(self) -> None:
                import json
                import time as _time

                now = _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime())
                nodes = []
                pods = []
                for part, provider in list(outer.providers.items()):
                    try:
                        cap, free = provider.capacity()
                    except Exception:
                        continue
                    nodes.append(
                        {
                            "nodeName": provider.node_name,
                            "startTime": now,
                            "cpu": {
                                "capacityCores": cap.get("cpu", 0.0),
                                "usageCores": cap.get("cpu", 0.0)
                                - free.get("cpu", 0.0),
                            },
                            "memory": {
                                "capacityBytes": int(
                                    cap.get("memory_mb", 0.0) * 1024 * 1024
                                ),
                                "usageBytes": int(
                                    (cap.get("memory_mb", 0.0)
                                     - free.get("memory_mb", 0.0)) * 1024 * 1024
                                ),
                            },
                        }
                    )
                    for pod, info in provider.pod_stats():
                        pods.append(
                            {
                                "podRef": {"name": pod.meta.name, "uid": pod.meta.uid},
                                "startTime": info.get("start_time", ""),
                                "cpu": {"requestedCores": info.get("cpus", 0.0)},
                                "state": info.get("state", ""),
                                "slurmJobIds": info.get("job_ids", []),
                            }
                        )
                body = json.dumps({"nodes": nodes, "pods": pods}).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _stream_logs(self, pod_name: str, follow: bool) -> None:
                provider = outer._find_provider(pod_name)
                if provider is None:
                    return self._plain(404, f"pod {pod_name} not found\n")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for chunk in provider.pod_logs(pod_name, follow=follow):
                        if not chunk:
                            continue
                        self.wfile.write(f"{len(chunk):x}\r\n".encode())
                        self.wfile.write(chunk)
                        self.wfile.write(b"\r\n")
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return  # client went away mid-follow (kubectl ^C)
                except Exception as exc:
                    log.warning("log stream for %s failed: %s", pod_name, exc)
                try:
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    pass

        httpd = ThreadingHTTPServer((self.address, self.port), Handler)
        if self.tls_cert_file and self.tls_key_file:
            from slurm_bridge_tpu_torch.utils.certs import ensure_self_signed

            # missing files are generated in place (tryPrepareTlsCerts,
            # server.go:344-347: "generate default tls cert files")
            if ensure_self_signed(self.tls_cert_file, self.tls_key_file):
                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                ctx.minimum_version = ssl.TLSVersion.TLSv1_2  # restricted ciphers
                ctx.load_cert_chain(self.tls_cert_file, self.tls_key_file)
                httpd.socket = ctx.wrap_socket(httpd.socket, server_side=True)
            else:
                log.warning("TLS bootstrap failed; serving plaintext (reference "
                            "falls back the same way when cert bootstrap fails)")
        self._httpd = httpd
        self.port = httpd.server_address[1]
        threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="vk-http").start()
        log.info("kubelet API on %s:%d", self.address, self.port)
        return self

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()  # release the bound listening socket
            self._httpd = None
