"""Driver layer of the port: the boundary between the client stack and
the service (JAX counterpart: ``fluidframework_tpu/driver``).

Ref: packages/loader/driver-definitions + packages/drivers (SURVEY §2.5).
A document service exposes three sub-services (driver-definitions):

- delta connection  — the live op stream (socket analog)
- delta storage     — sequenced-op backfill (REST /deltas analog)
- storage           — snapshots/blobs (historian/git analog)

``local`` binds them straight to an in-proc LocalServer (the local-driver
test backbone, packages/drivers/local-driver); ``file`` serves a recorded
document read-only (the replay tool's driver). The network driver and the
history client are not ported yet (ROADMAP A4).
"""

from .definitions import (
    DocumentDeltaConnection,
    DocumentDeltaStorage,
    DocumentService,
    DocumentServiceFactory,
    DocumentStorage,
)
from .file import FileDocumentService, FileDocumentServiceFactory
from .local import LocalDocumentServiceFactory

__all__ = [
    "DocumentDeltaConnection",
    "DocumentDeltaStorage",
    "DocumentService",
    "DocumentServiceFactory",
    "DocumentStorage",
    "FileDocumentService",
    "FileDocumentServiceFactory",
    "LocalDocumentServiceFactory",
]
