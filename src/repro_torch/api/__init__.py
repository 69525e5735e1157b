"""`repro_torch.api` — the front door of the port.

    from repro_torch.api import DesignRequest, DesignSession, Requirements

    art = DesignSession().run(DesignRequest(array_size=16384))

`DesignSession()` runs on CUDA; `DesignSession(device="cpu")` runs the
plain PyTorch path on the CPU.
"""
from repro_torch.api.request import DesignRequest, Requirements
from repro_torch.api.session import (BucketResult, DesignArtifact,
                                     DesignSession, DistilledBatch,
                                     ExploredBatch, LayoutBucket, Provenance)

__all__ = ["DesignRequest", "Requirements", "DesignArtifact",
           "DesignSession", "Provenance", "ExploredBatch", "DistilledBatch",
           "LayoutBucket", "BucketResult"]
