"""`repro_torch.api` — the front door of the port.

    from repro_torch.api import DesignRequest, DesignSession, Requirements

    art = DesignSession().run(DesignRequest(array_size=16384))

`DesignSession()` runs on CUDA; `DesignSession(device="cpu")` runs the
plain PyTorch path on the CPU.  `DesignSession(artifact_cache="/path")`
adds the persistent, cross-process `ArtifactCache` (or pass a two-tier
`TieredArtifactCache`); `repro_torch.serve.design_service.DesignService`
adds the queue-backed multi-tenant layer over a session.
"""
from repro_torch.api.artifact_cache import (ArtifactCache, FileRemoteStore,
                                            RemoteStore, TicketJournal,
                                            TieredArtifactCache)
from repro_torch.api.request import DesignRequest, Requirements
from repro_torch.api.session import (BucketResult, DesignArtifact,
                                     DesignSession, DistilledBatch,
                                     ExploredBatch, LayoutBucket, Provenance)

_DEFAULT_SESSION: DesignSession | None = None
_DEVICE_SESSIONS: dict[str, DesignSession] = {}


def default_session(*, device=None) -> DesignSession:
    """The process-wide session, made on first use, on `cuda` (raises
    without a CUDA device, like every entry point of the port).  With
    `device` (as `"cpu"`), the process-wide session of that device."""
    global _DEFAULT_SESSION
    if device is not None:
        key = str(device)
        if key != "cuda":
            if key not in _DEVICE_SESSIONS:
                _DEVICE_SESSIONS[key] = DesignSession(device=device)
            return _DEVICE_SESSIONS[key]
    if _DEFAULT_SESSION is None:
        _DEFAULT_SESSION = DesignSession()
    return _DEFAULT_SESSION


__all__ = ["DesignRequest", "Requirements", "DesignArtifact",
           "DesignSession", "Provenance", "ArtifactCache",
           "TieredArtifactCache", "RemoteStore", "FileRemoteStore",
           "TicketJournal", "ExploredBatch", "DistilledBatch",
           "LayoutBucket", "BucketResult", "default_session"]
