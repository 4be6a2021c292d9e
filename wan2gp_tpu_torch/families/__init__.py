"""Family handlers of the port: Wan, Krea 2, Flux, HunyuanVideo, LTX-2,
Qwen-Image and Z-Image."""
from .flux import FluxFamilyHandler
from .hyvideo import HunyuanFamilyHandler
from .krea2 import Krea2FamilyHandler
from .ltx2 import LTX2FamilyHandler
from .qwen import QwenImageFamilyHandler
from .wan import WanFamilyHandler
from .zimage import ZImageFamilyHandler

_HANDLER_CLASSES = (WanFamilyHandler, Krea2FamilyHandler, FluxFamilyHandler,
                    HunyuanFamilyHandler, LTX2FamilyHandler,
                    QwenImageFamilyHandler, ZImageFamilyHandler)


def build_handler_map():
    handlers = {}
    for cls in _HANDLER_CLASSES:
        for t in cls.query_supported_types():
            handlers[t] = cls
    return handlers
