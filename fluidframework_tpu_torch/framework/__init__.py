"""Framework/API layer: developer-facing sugar over runtime + DDS.

JAX counterpart: ``fluidframework_tpu/framework/__init__.py``; the port's copy,
imports rebased to this package.

Ref: packages/framework (SURVEY §2.6) — aqueduct DataObject/-Factory,
undo-redo stack managers, DDS interceptions, request routing.
"""

from .data_object import DataObject, DataObjectFactory, default_data_object
from .undo_redo import UndoRedoStackManager
from .interceptions import intercepted_map, intercepted_string

__all__ = [
    "DataObject",
    "DataObjectFactory",
    "default_data_object",
    "UndoRedoStackManager",
    "intercepted_map",
    "intercepted_string",
]
