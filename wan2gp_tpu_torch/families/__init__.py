"""Family handlers of the port: Wan, Krea 2, Flux, HunyuanVideo and LTX-2."""
from .flux import FluxFamilyHandler
from .hyvideo import HunyuanFamilyHandler
from .krea2 import Krea2FamilyHandler
from .ltx2 import LTX2FamilyHandler
from .wan import WanFamilyHandler

_HANDLER_CLASSES = (WanFamilyHandler, Krea2FamilyHandler, FluxFamilyHandler,
                    HunyuanFamilyHandler, LTX2FamilyHandler)


def build_handler_map():
    handlers = {}
    for cls in _HANDLER_CLASSES:
        for t in cls.query_supported_types():
            handlers[t] = cls
    return handlers
