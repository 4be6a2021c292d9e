"""Model-definition registry (the t2v part of wan2gp_tpu/config/registry.py).

Reads the built-in `defaults/<model_type>.json` files, each holding
{"model": {...}, **settings}; "model.architecture" names the base model
type that picks the family handler.  Finetune overlays and URL
resolution (checkpoint loading) are not ported yet.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

_BUILTIN_DEFAULTS = os.path.join(os.path.dirname(__file__), "defaults")


class ModelRegistry:
    def __init__(self, handlers: Optional[Dict[str, Any]] = None):
        """handlers: {base_model_type: family_handler}."""
        self.handlers = dict(handlers or {})
        self.models_def: Dict[str, Dict[str, Any]] = {}
        for path in sorted(glob.glob(os.path.join(_BUILTIN_DEFAULTS,
                                                  "*.json"))):
            model_type = os.path.basename(path)[:-5]
            with open(path, encoding="utf-8") as f:
                settings = json.load(f)
            model_def = settings.pop("model")
            model_def["path"] = path
            base = model_def.get("architecture") or model_type
            handler = self.handlers.get(base)
            if handler is None:
                model_def["visible"] = False
            else:
                model_def = {**(handler.query_model_def(base, model_def)
                                or {}), **model_def}
            model_def["settings"] = settings
            self.models_def[model_type] = model_def

    def model_types(self) -> List[str]:
        return list(self.models_def)

    def get(self, model_type: str) -> Dict[str, Any]:
        return self.models_def[model_type]

    def base_model_type(self, model_type: str) -> str:
        return self.models_def[model_type].get("architecture") or model_type

    def handler_for(self, model_type: str):
        return self.handlers[self.base_model_type(model_type)]

    def default_settings(self, model_type: str) -> Dict[str, Any]:
        """Handler defaults, overlaid with the model file's settings."""
        base = self.base_model_type(model_type)
        settings = dict(self.handler_for(model_type).default_settings(base))
        settings.update(self.get(model_type)["settings"])
        settings["model_type"] = model_type
        return settings
