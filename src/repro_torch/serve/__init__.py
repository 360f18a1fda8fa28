"""``repro_torch.serve`` — resumable async serving over the exploration
stack (the port's copy of ``repro.serve``).

The layer between "a ``Session`` answers one blocking ``submit``" and "a
fleet of services shares one cache directory":

* ``JobHandle`` / ``Executor`` — ``Session.submit_async(query)`` returns
  a handle (poll / await / cancel / streamed ``SegmentEvent``s) while a
  worker-thread pool runs the search; each worker owns a
  ``Session.clone()`` and the lock-arbitrated cache directory is the
  only shared state.
* ``JobStore`` / ``JobRecord`` — the durable job journal: one
  atomically-written JSON file per job, lock-arbitrated claims keyed on
  ``Problem.key()``, PID-liveness crash recovery.  Every job runs with
  ``resume=True``, so a SIGKILLed attempt leaves an engine checkpoint
  the next attempt restores — residual-budget spend, bit-identical final
  front.
* Admission control + graceful degradation — past ``max_pending``
  in-flight jobs, a warm query is answered immediately with its
  freshest cached front (``provenance.stale=True``) and the refinement
  stays banked in the store (``Executor.resume_pending`` or the
  ``python -m repro_torch.serve.worker --device cuda|cpu`` CLI picks it up
  later).

Several worker threads of one process share one card; each clone owns
its service, so no tensor crosses threads.
"""

from .executor import (CancelledError, Executor, JobHandle,  # noqa: F401
                       query_from_payload, query_to_payload, run_job,
                       stale_result)
from .jobs import (CANCELLED, DONE, FAILED, PENDING,  # noqa: F401
                   RUNNING, TERMINAL, JobRecord, JobStore,
                   graph_from_json, graph_to_json)

__all__ = [
    "CANCELLED", "CancelledError", "DONE", "Executor", "FAILED",
    "JobHandle", "JobRecord", "JobStore", "PENDING", "RUNNING",
    "TERMINAL", "graph_from_json", "graph_to_json", "query_from_payload",
    "query_to_payload", "run_job", "stale_result",
]
