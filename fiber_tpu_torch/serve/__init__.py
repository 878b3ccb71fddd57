"""fiber_tpu_torch.serve — the long-lived multi-tenant serving tier
(docs/serving.md).

The reference fiber's cluster layer kept the pod alive across jobs —
scripts *connect to* a cluster, they don't own one. This package is
that front door rebuilt TPU-natively: one persistent daemon
(``fiber-tpu serve``) owns the host agents and the shared
scheduler/dispatch plane, and many clients submit jobs over the
authenticated request/reply transport (``fiber_tpu_torch/utils/serve.py``).

Layout:

- :mod:`fiber_tpu_torch.serve.protocol` — wire verbs, job states, validation
  shared by daemon and client;
- :mod:`fiber_tpu_torch.serve.jobs` — :class:`JobRunner`, the daemon-ownable
  refactor of ``Pool`` job lifecycle (submit/track/replay), journaling
  every job through the durable ledger;
- :mod:`fiber_tpu_torch.serve.admission` — quota + health gating and the
  budget-breach escalation from WDRR throttling to real preemption;
- :mod:`fiber_tpu_torch.serve.warmpool` — elastic standby worker scaling
  driven by the scheduler's in-flight/queued load;
- :mod:`fiber_tpu_torch.serve.daemon` — the serving daemon itself;
- :mod:`fiber_tpu_torch.serve.client` — the thin client (``fiber-tpu
  submit`` and library use).
"""

from fiber_tpu_torch.serve.admission import AdmissionController, AdmissionError  # noqa: F401
from fiber_tpu_torch.serve.client import ServeClient  # noqa: F401
from fiber_tpu_torch.serve.daemon import DEFAULT_SERVE_PORT, ServeDaemon  # noqa: F401
from fiber_tpu_torch.serve.jobs import JobRunner  # noqa: F401
from fiber_tpu_torch.serve.protocol import JOB_STATES, PROTOCOL_VERSION  # noqa: F401
from fiber_tpu_torch.serve.warmpool import WarmPool  # noqa: F401

__all__ = [
    "AdmissionController",
    "AdmissionError",
    "DEFAULT_SERVE_PORT",
    "JOB_STATES",
    "JobRunner",
    "PROTOCOL_VERSION",
    "ServeClient",
    "ServeDaemon",
    "WarmPool",
]
