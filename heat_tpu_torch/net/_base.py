"""Loopback bind policy + atomic HTTP server lifecycle.

Port of ``heat_tpu/net/_base.py`` (stdlib only, copied): the
loopback-only enforcement and the start-in-constructor /
synchronous-idempotent-``close()`` thread lifecycle, in one place for
every listener of the package (``telemetry.httpz.MetricsServer``), so the
security posture cannot fork.
"""

from __future__ import annotations

import http.server
import threading

__all__ = ["LOOPBACK_HOSTS", "check_loopback", "LoopbackHTTPServer"]

#: The only bind hosts any listener of the package accepts.  These endpoints
#: expose unauthenticated operational internals; a non-loopback bind
#: would face them at a network.
LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")


def check_loopback(host: str, *, what: str = "listener") -> str:
    """Validate a bind host against the loopback-only policy.

    Returns the host unchanged when it is loopback; raises ``ValueError``
    otherwise.  ``what`` names the listener in the error message.
    """
    if host not in LOOPBACK_HOSTS:
        raise ValueError(
            f"{what} binds loopback only (host={host!r} refused): "
            "the endpoint is unauthenticated — front it with a "
            "node-local agent instead of exposing it to a network"
        )
    return host


class LoopbackHTTPServer:
    """A loopback-only stdlib ``ThreadingHTTPServer`` on a daemon thread.

    The lifecycle is atomic: the constructor validates the bind host,
    binds the socket (``port=0`` picks a free ephemeral port — read it
    back from ``.port``), and starts the serving thread, so a constructed
    object is always live.  ``close()`` shuts it down synchronously and
    is idempotent; the instance works as a context manager.
    """

    def __init__(
        self,
        handler: type,
        *,
        port: int = 0,
        host: str = "127.0.0.1",
        name: str = "heat-http",
    ):
        check_loopback(host, what=type(self).__name__)
        self._httpd = http.server.ThreadingHTTPServer((host, int(port)), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = int(self._httpd.server_address[1])
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"{name}:{self.port}",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._thread.join(timeout=5)
            self._httpd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
