"""Family handlers of the port: Wan, Krea 2, Flux and HunyuanVideo."""
from .flux import FluxFamilyHandler
from .hyvideo import HunyuanFamilyHandler
from .krea2 import Krea2FamilyHandler
from .wan import WanFamilyHandler

_HANDLER_CLASSES = (WanFamilyHandler, Krea2FamilyHandler, FluxFamilyHandler,
                    HunyuanFamilyHandler)


def build_handler_map():
    handlers = {}
    for cls in _HANDLER_CLASSES:
        for t in cls.query_supported_types():
            handlers[t] = cls
    return handlers
