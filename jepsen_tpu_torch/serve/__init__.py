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

Start one with ``python -m jepsen_tpu_torch.serve`` (on the card) or
``--device cpu``, a supervised fleet with ``--supervise --fleet N`` and
its front with ``python -m jepsen_tpu_torch.serve.router --member
HOST:PORT …``; reach it with ``checker.linearizable(model,
algorithm="service", client=ServiceClient(port=...))``, ``elle``'s
``client=`` arguments, :func:`check_batch`, or a feed session.

Not ported: the reference's shared AOT executable cache (a first dispatch
on CUDA compiles nothing), its ``top`` command and web panel (harness
parts), and its chaos drills (``serve/chaos.py``).
"""

from .client import (  # noqa: F401
    CircuitBreaker,
    FeedSession,
    ServiceChecker,
    ServiceClient,
    ServiceError,
    ServiceUnavailable,
    analysis,
    check_batch,
    format_fleet_status,
    probe_healthz,
    resolve_client,
    screen_graphs,
    spawn_daemon,
)
from .daemon import (  # noqa: F401
    CheckerDaemon,
    fleet_member_args,
    serve,
    supervise,
    supervise_fleet,
)
from .router import (  # noqa: F401
    MIN_ROUTE_WEIGHT,
    Router,
    check_route_key,
    elle_route_key,
    rendezvous_order,
    weight_from_busy,
)
from .protocol import DEFAULT_HOST, DEFAULT_PORT, UnsupportedModel  # noqa: F401
