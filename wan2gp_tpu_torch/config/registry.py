"""Model-definition registry (the t2v part of wan2gp_tpu/config/registry.py).

Reads the built-in `defaults/<model_type>.json` files, each holding
{"model": {...}, **settings}; "model.architecture" names the base model
type that picks the family handler; "URLs", "URLs2" and "preload_URLs"
may name another model type, whose files the model then shares (Qwen
Image Edit Plus borrows Qwen Image Edit's `preload_URLs`).  Finetune
overlays are not ported yet.
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
        for model_def in self.models_def.values():
            for prop in ("URLs", "URLs2", "preload_URLs"):
                if prop in model_def:
                    model_def[prop] = self._borrowed(model_def, prop, ())

    def _borrowed(self, model_def, prop, stack):
        """The value of prop, following a model type it names instead of
        a URL list."""
        value = model_def.get(prop, [])
        if isinstance(value, str) and not value.startswith(("http", "/",
                                                              ".")):
            if value in stack:
                raise ValueError(f"circular {prop} reference via {value}")
            return self._borrowed(self.models_def[value], prop,
                                  stack + (value,))
        return value

    def model_types(self) -> List[str]:
        return list(self.models_def)

    def get(self, model_type: str) -> Dict[str, Any]:
        return self.models_def[model_type]

    def base_model_type(self, model_type: str) -> str:
        return self.models_def[model_type].get("architecture") or model_type

    def handler_for(self, model_type: str):
        return self.handlers[self.base_model_type(model_type)]

    def default_settings(self, model_type: str) -> Dict[str, Any]:
        """Handler defaults (by base model type, then, where the handler
        has `definition_settings`, by the definition), overlaid with the
        model file's settings."""
        base = self.base_model_type(model_type)
        handler = self.handler_for(model_type)
        settings = dict(handler.default_settings(base))
        per_definition = getattr(handler, "definition_settings", None)
        if per_definition is not None:
            settings.update(per_definition(base, self.get(model_type)))
        settings.update(self.get(model_type)["settings"])
        settings["model_type"] = model_type
        return settings
