"""heat_tpu_torch.net — the loopback-only network plane.

Every socket the package opens is an *operational* surface (the metrics
scrape), not a product surface: it carries unauthenticated internals.
The rule, as in ``heat_tpu.net``, is **loopback only**: binds to
non-loopback hosts are refused at construction time.

- ``_base`` — the bind-host policy (``check_loopback``) and the atomic
  daemon-thread HTTP server lifecycle (``LoopbackHTTPServer``).

The reference's replica RPC framing (``wire``) comes with the serving
plane.
"""

from ._base import LOOPBACK_HOSTS, LoopbackHTTPServer, check_loopback

__all__ = ["LOOPBACK_HOSTS", "LoopbackHTTPServer", "check_loopback"]
