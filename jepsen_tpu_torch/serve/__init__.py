"""The resident checker service of the port: one long-lived process owns
the CUDA device, the loaded kernel libraries and the oracle pool; client
runs send histories over local HTTP, in the reference's wire protocol,
and same-shape buckets from concurrent runs share launches.

- :mod:`.protocol` — wire forms of models, histories, options and Elle
  screens, and the codec (byte-equal to the reference's).
- :mod:`.daemon` — :class:`CheckerDaemon` and :func:`serve`: admission,
  the device thread and cross-run coalescing, the endpoints.
- :mod:`.client` — :class:`ServiceClient`, the :func:`check_batch` /
  :func:`screen_graphs` seams with their counted fallback, and
  :func:`spawn_daemon`.

Start one with ``python -m jepsen_tpu_torch.serve`` (on the card) or
``--device cpu``; reach it with ``checker.linearizable(model,
algorithm="service", client=ServiceClient(port=...))``, ``elle``'s
``client=`` arguments, or :func:`check_batch`.
"""

from .client import (  # noqa: F401
    CircuitBreaker,
    ServiceChecker,
    ServiceClient,
    ServiceError,
    ServiceUnavailable,
    analysis,
    check_batch,
    probe_healthz,
    resolve_client,
    screen_graphs,
    spawn_daemon,
)
from .daemon import CheckerDaemon, serve  # noqa: F401
from .protocol import DEFAULT_HOST, DEFAULT_PORT, UnsupportedModel  # noqa: F401
