"""Study-as-a-service: manifests in, batched execution, labeled results out.

Port of ``repro.serve`` on one device (the card unless ``device=`` says
otherwise):

* :mod:`repro_torch.serve.cache` — :class:`ExecutableCache`, the bounded
  LRU of (structure fingerprint, ExecutionConfig)-keyed runners with
  hit/miss/eviction/compile counters.
* :mod:`repro_torch.serve.service` — :class:`StudyService` (submit /
  flush / wait over serialized Study manifests, structure-batched
  through :func:`repro_torch.experiments.engine.execute_cells`, and
  :meth:`~StudyService.recover` of checkpointed dispatches) and
  :class:`BackgroundServer` (the batching-window flush thread).

The wire format lives in :mod:`repro_torch.experiments.manifest`; the
key pieces are re-exported here so a client script needs one import.
"""

from repro_torch.experiments.manifest import (
    EXEC_FORMAT,
    REQUEST_FORMAT,
    STUDY_FORMAT,
    request_from_manifest,
    request_to_manifest,
    study_from_manifest,
    study_to_manifest,
)
from repro_torch.serve.cache import BoundExecutableCache, ExecutableCache
from repro_torch.serve.service import (
    DISPATCH_FORMAT,
    BackgroundServer,
    ServeResponse,
    StudyService,
)

__all__ = [
    "DISPATCH_FORMAT", "EXEC_FORMAT", "REQUEST_FORMAT", "STUDY_FORMAT",
    "BackgroundServer", "BoundExecutableCache", "ExecutableCache",
    "ServeResponse", "StudyService",
    "request_from_manifest", "request_to_manifest",
    "study_from_manifest", "study_to_manifest",
]
