"""GenerationService: settings dict -> video or image files.

Counterpart of wan2gp_tpu/runtime/service.py for the Wan t2v/i2v, VACE and
Multitalk and the Krea 2 text-to-image paths: model resolution and a
pipeline cache, settings merge, resolution alignment, family dispatch
(models whose definition has `image_outputs` go through the handler's
`generate_image` and are saved as PNG) and saving with embedded settings
(and a handler's `audio` as the AVI's PCM16 stream).  Settings keys follow
the reference task format (prompt, negative_prompt, resolution "WxH",
video_length, num_inference_steps, guidance_scale, flow_shift,
sample_solver, seed, model_type, ...).

Weights are random (`init_random_weights`) or loaded from the files that
`checkpoints_resolver` names for each role of the handler
(`io.downloads.make_checkpoints_resolver` finds them on disk).

Not ported yet (ROADMAP Queue 1): plugins, LoRA, profiles, config groups,
multi-chip meshes and post-processing.
"""
from __future__ import annotations

import dataclasses
import os
import random
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..config.registry import ModelRegistry
from ..config.resolutions import parse_resolution, resolve_resolution
from ..device import resolve_device
from ..families import build_handler_map
from ..utils import media


def quantize_dit_params(params, mode: str):
    """Quantize transformer-block linears on load: every stacked
    {"w": [L, K, N]} under a *blocks* subtree with K, N >= 256 becomes
    {"w_q"|"w_q4", "scale"}; embeddings, norms and modulation stay float.
    Modes: "int8" (or "quanto_int8"), "int4", and "int8a8" / "int4a8",
    which store the weights as "int8" / "int4" do; their int8 activations
    are the DiT config's `act_quant` (see `activation_mode`), never a
    process-wide setting.  Each float weight it quantizes is removed from
    `params`.  A tree with no linear that qualifies raises a ValueError
    (the JAX function returns it unchanged, so the mode asked for would
    silently not apply)."""
    from ..ops.quant import quantize_params_tree
    bits = {"int8": 8, "quanto_int8": 8, "int8a8": 8, "int4": 4,
            "int4a8": 4}.get(mode)
    if bits is None:
        raise ValueError(f"unknown quantization mode {mode!r} (use 'int8', "
                         "'int4', 'int8a8' or 'int4a8')")
    out = quantize_params_tree(params, predicate=lambda path: "blocks" in path,
                               bits=bits, min_dim=256)
    if not any(k in ("w_q", "w_q4") for k in _keys(out)):
        raise ValueError(
            f"quantize {mode!r}: no block linear has K and N >= 256, so "
            "nothing would be quantized")
    return out


def _keys(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield k
            yield from _keys(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _keys(v)


def activation_mode(mode: str) -> str:
    """The DiT's `act_quant` for a quantize mode: "int8" for the "a8"
    modes, else "bf16"."""
    return "int8" if mode.endswith("a8") else "bf16"


class GenerationService:
    def __init__(self, registry: Optional[ModelRegistry] = None,
                 output_dir: str = "outputs", attn_backend: str = "auto",
                 init_random_weights: bool = False,
                 checkpoints_resolver: Optional[Callable] = None,
                 quantize: str = "", device=None):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry(build_handler_map())
        self.output_dir = output_dir
        self.attn_backend = attn_backend
        self.init_random_weights = init_random_weights
        # (model_type, handler, base_model_type, model_def) -> {role: path}
        self.checkpoints_resolver = checkpoints_resolver
        self.quantize = quantize or ""
        self._pipelines: Dict[str, Any] = {}

    # -- model management ----------------------------------------------

    def get_pipeline(self, model_type: str, model_def: Optional[dict] = None):
        pipe = self._pipelines.get(model_type)
        if pipe is None:
            if model_def is None:
                model_def = self.registry.get(model_type)
            handler = self.registry.handler_for(model_type)
            base = self.registry.base_model_type(model_type)
            modes = getattr(handler, "quantize_modes", None)
            if self.quantize and modes is not None \
                    and self.quantize not in modes:
                raise ValueError(
                    f"quantize={self.quantize!r} is not supported for "
                    f"{model_type}: {handler.quantize_refusal}")
            ckpts = None
            if not self.init_random_weights:
                if self.checkpoints_resolver is None:
                    raise RuntimeError(
                        "no checkpoints_resolver configured; pass "
                        "init_random_weights=True for synthetic runs")
                ckpts = self.checkpoints_resolver(model_type, handler, base,
                                                  model_def)
            pipe = handler.load_model(
                base, model_def, checkpoints=ckpts,
                attn_backend=self.attn_backend,
                init_random=self.init_random_weights, device=self.device)
            if self.quantize:
                # one expert after the other: each float weight goes as it
                # is quantized, so two bf16 14B experts never meet a full
                # quantized copy
                aq = activation_mode(self.quantize)
                pipe.dit_params = quantize_dit_params(pipe.dit_params,
                                                      self.quantize)
                pipe.dit_cfg = dataclasses.replace(pipe.dit_cfg,
                                                   act_quant=aq)
                if getattr(pipe, "dit_params2", None) is not None:
                    pipe.dit_params2 = quantize_dit_params(
                        pipe.dit_params2, self.quantize)
            self._pipelines[model_type] = pipe
        return pipe

    def release_model(self, model_type: Optional[str] = None):
        if model_type is None:
            self._pipelines.clear()
        else:
            self._pipelines.pop(model_type, None)

    # -- generation -------------------------------------------------------

    def generate(self, settings: Dict[str, Any],
                 on_progress: Optional[Callable] = None) -> List[str]:
        """Run one task; returns the list of output file paths."""
        s = dict(settings)
        model_type = s.get("model_type") or "t2v_1.3B"
        defaults = self.registry.default_settings(model_type)
        model_def = self.registry.get(model_type)
        merged = {**defaults, **s}
        seed = int(merged.get("seed", -1))
        if seed < 0:
            seed = random.randint(0, 2 ** 31 - 1)
            merged["seed"] = seed
        requested = merged.get("resolution", "832x480")
        merged["resolution"] = resolve_resolution(model_def, requested) \
            or requested
        width, height = parse_resolution(merged["resolution"])

        pipe = self.get_pipeline(model_type, model_def=model_def)
        if merged.get("attention_mode"):
            pipe.attn_backend = str(merged["attention_mode"])
        os.makedirs(self.output_dir, exist_ok=True)
        if on_progress:
            on_progress("status", f"generating with {model_type}")
        handler = self.registry.handler_for(model_type)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        if model_def.get("image_outputs"):
            img = handler.generate_image(pipe, merged, width, height, seed)
            path = os.path.join(self.output_dir,
                                f"{model_type}_{stamp}_{seed}.png")
            media.save_image(np.asarray(img), path,
                             metadata=_clean_settings(merged))
            return [path]
        frame_num = int(merged.get("video_length", 81))
        result = handler.generate_video(pipe, merged, width, height,
                                        frame_num, seed)
        path = os.path.join(self.output_dir,
                            f"{model_type}_{stamp}_{seed}.avi")
        # a waveform in the result (Multitalk: the driving audio) is muxed
        # into the AVI as its PCM16 stream
        path = media.save_video(
            np.asarray(result["video"]), path,
            fps=int(result.get("fps", 16)), metadata=_clean_settings(merged),
            audio=result.get("audio"),
            audio_sample_rate=int(result.get("audio_sample_rate", 16000)))
        return [path]

    # -- queue worker ------------------------------------------------------

    def process_queue(self, queue, on_event: Optional[Callable] = None):
        """Drain the queue.  Returns exit code: 0 ok, 1 a task errored."""
        code = 0
        while True:
            task = queue.next_pending()
            if task is None:
                break
            task.status = "running"
            if on_event:
                on_event("task_start", task)
            try:
                task.outputs = self.generate(
                    task.settings,
                    on_progress=(lambda kind, data:
                                 on_event(kind, data) if on_event else None))
                task.status = "done"
            except Exception as e:  # noqa: BLE001 — a task error ends the queue
                task.status = "error"
                task.error = f"{type(e).__name__}: {e}"
                code = 1
                if on_event:
                    on_event("task_error", task)
                break
            if on_event:
                on_event("task_done", task)
        return code


def _clean_settings(settings: Dict[str, Any]) -> Dict[str, Any]:
    """The settings to embed in an output: no private keys, nothing that
    JSON cannot hold (an `image_start` array, a list of them)."""
    return {k: v for k, v in settings.items()
            if not k.startswith("_") and _jsonable(v)}


def _jsonable(v):
    if isinstance(v, (list, tuple)):
        return all(_jsonable(x) for x in v)
    if isinstance(v, dict):
        return all(isinstance(k, str) and _jsonable(x) for k, x in v.items())
    return isinstance(v, (str, int, float, bool, type(None)))
