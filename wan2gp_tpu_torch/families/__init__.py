"""Family handlers of the port (only Wan t2v so far)."""
from .wan import WanFamilyHandler

_HANDLER_CLASSES = (WanFamilyHandler,)


def build_handler_map():
    handlers = {}
    for cls in _HANDLER_CLASSES:
        for t in cls.query_supported_types():
            handlers[t] = cls
    return handlers
