"""The resident checker service of the port: one long-lived process owns
the CUDA device, the loaded kernel libraries and the oracle pool; client
runs send histories over local HTTP, in the reference's wire protocol,
and same-shape buckets from concurrent runs share launches.

- :mod:`.protocol` — wire forms of models, histories, options and Elle
  screens, and the codec (byte-equal to the reference's).
- :mod:`.daemon` — :class:`CheckerDaemon` and :func:`serve`: admission,
  the device thread and cross-run coalescing, the endpoints (``/feed``
  online sessions and the ``/watch`` verdict channel among them), and
  the supervisor (:func:`supervise`, :func:`supervise_fleet`).
- :mod:`.client` — :class:`ServiceClient` (with :meth:`~ServiceClient.
  open_feed` and :meth:`~ServiceClient.watch`), :class:`FeedSession`, the
  :func:`check_batch` / :func:`screen_graphs` seams with their counted
  fallback, and :func:`spawn_daemon`.
- :mod:`.router` — :class:`Router`: one front over a fleet of daemons,
  rendezvous-hashed by request shape, with ``/feed`` sessions pinned.
- :mod:`.chaos` — ``python -m jepsen_tpu_torch.serve.chaos``: the
  self-chaos drills (kill -9 and WAL resume, a stalled socket and the
  breaker, a dropped response, WAL compaction under a crash, a fleet
  member's death).

Start one with ``python -m jepsen_tpu_torch.serve`` (on the card) or
``--device cpu``, a supervised fleet with ``--supervise --fleet N`` and
its front with ``python -m jepsen_tpu_torch.serve.router --member
HOST:PORT …``; reach it with ``checker.linearizable(model,
algorithm="service", client=ServiceClient(port=...))``, ``elle``'s
``client=`` arguments, :func:`check_batch`, or a feed session.

The CLI's ``serve --checker``, ``status``, ``shutdown``, ``route``,
``top`` and ``profile`` commands (:mod:`jepsen_tpu_torch.cli`) drive
these parts; the store's web UI (:mod:`jepsen_tpu_torch.web`) shows a
daemon's live panel.  Not ported: the reference's shared AOT executable
cache (a first dispatch on CUDA compiles nothing).

The names below load their module at first use, so importing the
package imports no torch: ``python -m jepsen_tpu_torch.serve`` starts its
CUDA probe before the daemon's imports.
"""

import importlib

#: each exported name → the submodule that defines it
_EXPORTS = {
    "client": ("CircuitBreaker", "FeedSession", "ServiceChecker",
               "ServiceClient", "ServiceError", "ServiceUnavailable",
               "analysis", "check_batch", "format_fleet_status",
               "probe_healthz", "resolve_client", "screen_graphs",
               "spawn_daemon"),
    "daemon": ("CheckerDaemon", "fleet_member_args", "serve", "supervise",
               "supervise_fleet"),
    "router": ("MIN_ROUTE_WEIGHT", "Router", "check_route_key",
               "elle_route_key", "rendezvous_order", "weight_from_busy"),
    "protocol": ("DEFAULT_HOST", "DEFAULT_PORT", "UnsupportedModel"),
}
_HOME = {name: mod for mod, names in _EXPORTS.items() for name in names}
__all__ = sorted(_HOME)


def __getattr__(name: str):
    mod = _HOME.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{mod}", __name__), name)
    globals()[name] = value
    return value
