"""Family handlers of the port: Wan, Krea 2 and Flux."""
from .flux import FluxFamilyHandler
from .krea2 import Krea2FamilyHandler
from .wan import WanFamilyHandler

_HANDLER_CLASSES = (WanFamilyHandler, Krea2FamilyHandler, FluxFamilyHandler)


def build_handler_map():
    handlers = {}
    for cls in _HANDLER_CLASSES:
        for t in cls.query_supported_types():
            handlers[t] = cls
    return handlers
