"""GenerationService: settings dict -> video or image files.

Counterpart of wan2gp_tpu/runtime/service.py for the Wan t2v/i2v, VACE and
Multitalk, HunyuanVideo 1.5 t2v, LTX-2 text-to-audio+video, and the Krea 2,
Flux, Qwen-Image and Z-Image text-to-image paths: model resolution and a
pipeline cache, settings merge, resolution alignment, family dispatch (models whose definition has `image_outputs` go
through the handler's
`generate_image` and are saved as PNG) and saving with embedded settings
(and a handler's `audio` as the AVI's PCM16 stream, at its
`audio_sample_rate`: Multitalk's 16 kHz mono, LTX-2's 24 kHz stereo).  Settings keys follow
the reference task format (prompt, negative_prompt, resolution "WxH",
video_length, num_inference_steps, guidance_scale, flow_shift,
sample_solver, seed, model_type, ...).

Weights are random (`init_random_weights`) or loaded from the files that
`checkpoints_resolver` names for each role of the handler
(`io.downloads.make_checkpoints_resolver` finds them on disk).

A request may name a settings `profile` ("family/name", or a name looked
for in every family) and a LoRA preset `lset_name` (a .lset under its
`lora_dir`, else `lora_root`), which underlay its settings as in the JAX
service, and LoRAs (`loras`, else `activated_loras`, by path, name or URL,
found under `lora_root` by `io.downloads.resolve_lora_file`) with
`loras_multipliers`.  On a Wan model with one expert and float weights
the LoRAs merge into the DiT's weights (`lora.MergedLoras`): a request
with the same files and multipliers reuses the merge, and any other
request first restores the base weights bit for bit (the JAX service
merges into its cached weights again at every request).  What the port
cannot honour raises a ValueError before any work, naming ROADMAP Queue 1
item 16: a LoRA on another family, on a second expert, on quantized
weights, or with a multiplier that changes over the steps.  A handler's
`check_request(base_model_type, model_def, merged, from_files)`, where
it has one, refuses what its family does not run in the same way, before
the model loads (Qwen-Image's reference images, the Z-Image control rows,
Flux's nvfp4 rows and the Flux definitions that need a LoRA from files).

Not ported yet (ROADMAP Queue 1): plugins, config groups, multi-chip
meshes and post-processing.
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
from ..lora import LATER as LORA_LATER
from ..utils import media


def quantize_dit_params(params, mode: str):
    """Quantize transformer-block linears on load: every {"w": [L, K, N]}
    under a *blocks* path with K, N >= 256 becomes {"w_q"|"w_q4",
    "scale"}, the blocks' modulation linears among them (Flux's and
    HunyuanVideo's `mod`, HunyuanVideo's refiner `ada`: fp32 products at
    M = batch, which take the fp32 GEMV kernel), and LTX-2's blocks (the
    JAX service quantizes a `dit_params` that its LTX-2 pipeline does not
    have, so there nothing changes); the embedders, the patch embedding,
    the final layer and the norms stay float.
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
                 quantize: str = "", device=None, lora_root: str = "loras"):
        self.device = resolve_device(device)
        self.registry = registry or ModelRegistry(build_handler_map())
        self.output_dir = output_dir
        self.attn_backend = attn_backend
        self.init_random_weights = init_random_weights
        # (model_type, handler, base_model_type, model_def) -> {role: path}
        self.checkpoints_resolver = checkpoints_resolver
        self.quantize = quantize or ""
        self.lora_root = lora_root
        self._pipelines: Dict[str, Any] = {}
        # model_type -> the LoRAs merged into its pipeline's DiT
        self._merged: Dict[str, Any] = {}

    def list_loras(self, model_type: str = "") -> Dict[str, Any]:
        """The LoRA files and presets for a model under `lora_root`."""
        from ..config.profiles import discover_loras
        family = (getattr(self.registry.handler_for(model_type), "family",
                          "") if model_type else "")
        return discover_loras(self.lora_root, model_type, family)

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
        for mt in [m for m in self._merged
                   if model_type is None or m == model_type]:
            self._merged.pop(mt).release()
        if model_type is None:
            self._pipelines.clear()
        else:
            self._pipelines.pop(model_type, None)

    # -- LoRA -------------------------------------------------------------

    def lora_plan(self, merged: Dict[str, Any]):
        """(paths, multipliers) of the request's LoRAs, or None.  Raises
        before any work where the port cannot merge them: a family other
        than Wan, a model with a second expert, a quantizing service, a
        quanto-int8 DiT file, a multiplier that changes over the steps
        (ValueError), or a file that is not on disk (FileNotFoundError)."""
        from ..io.downloads import resolve_lora_file
        from ..lora import parse_lora_multipliers
        names = list(merged.get("loras") or merged.get("activated_loras")
                     or [])
        if not names:
            return None
        model_type = merged["model_type"]
        family = getattr(self.registry.handler_for(model_type), "family", "")
        asked = f"LoRA {[os.path.basename(str(n)) for n in names]} on " \
                f"{model_type}"
        if family != "wan":
            raise ValueError(
                f"{asked}: the {family} family takes no LoRA in this port "
                f"yet ({LORA_LATER}: LoRA on HunyuanVideo, LTX-2, Flux and "
                "Krea 2)")
        if self.registry.get(model_type).get("multiple_submodels"):
            raise ValueError(
                f"{asked}: a LoRA for a model with two experts is not "
                f"ported yet ({LORA_LATER}: the second expert with "
                "per-phase multipliers; the JAX service merges into the "
                "first expert only)")
        if self.quantize:
            raise ValueError(
                f"{asked} with quantize={self.quantize!r}: a LoRA does not "
                f"merge into int8 / int4 weights yet ({LORA_LATER}: LoRA on "
                "quantized weights)")
        quanto = self._quanto_dit_file(model_type)
        if quanto:
            raise ValueError(
                f"{asked}: its DiT file {os.path.basename(quanto)!r} holds "
                "quanto-int8 weights, and a LoRA does not merge into int8 "
                f"weights yet ({LORA_LATER}: LoRA on quantized weights)")
        steps = int(merged.get("num_inference_steps", 30))
        sched = parse_lora_multipliers(merged.get("loras_multipliers", ""),
                                       len(names), steps)
        if (sched != sched[:, :1]).any():
            raise ValueError(
                f"{asked}: multipliers "
                f"{merged.get('loras_multipliers')!r} change over the "
                f"{steps} steps; a per-step schedule is not ported yet "
                f"({LORA_LATER}: per-step schedules; the JAX service "
                "merges step 0's multiplier for every step)")
        paths = [resolve_lora_file(str(n), self.lora_root, model_type,
                                   family) for n in names]
        return paths, [float(m) for m in sched[:, 0]]

    def _quanto_dit_file(self, model_type: str) -> Optional[str]:
        """The DiT file that get_pipeline would load for model_type when it
        holds quanto-int8 weights (weight._data keys in its header), else
        None.  A loaded pipeline is left to match_lora, which refuses a
        quantized linear before any weight changes; a GGUF DiT is
        dequantized to float on load and takes a LoRA."""
        if model_type in self._pipelines or self.init_random_weights \
                or self.checkpoints_resolver is None:
            return None
        from ..io.safetensors_reader import SafetensorsFile
        path = self.checkpoints_resolver(
            model_type, self.registry.handler_for(model_type),
            self.registry.base_model_type(model_type),
            self.registry.get(model_type)).get("transformer") or ""
        if not path.endswith(".safetensors"):
            return None
        f = SafetensorsFile(path)
        try:
            quanto = any(k.endswith(".weight._data") for k in f.keys())
        finally:
            f.close()
        return path if quanto else None

    def sync_loras(self, model_type: str, pipe, plan,
                   on_progress: Optional[Callable] = None):
        """Make the pipeline's DiT carry exactly the LoRAs of `plan`
        (lora_plan's result; None: none): reuse the merge when the files
        and multipliers are the same, else restore the base weights and
        merge.  Unmatched paths are reported through on_progress."""
        from .. import lora as L
        state = self._merged.get(model_type)
        if plan is None:
            if state is not None:
                state.restore()
            return
        paths, mults = plan
        key = tuple((p, os.stat(p).st_mtime_ns, m)
                    for p, m in zip(paths, mults))
        if state is not None and state.key == key:
            return
        if getattr(pipe, "dit_params2", None) is not None:
            raise ValueError(
                f"LoRA on {model_type}: the pipeline has a second expert "
                f"({LORA_LATER})")
        state = self._merged.setdefault(model_type, L.MergedLoras())
        unmatched = state.merge(pipe.dit_params,
                                [L.read_lora(p) for p in paths], mults,
                                names=paths)
        state.key = key
        if unmatched and on_progress:
            on_progress("status", f"{len(unmatched)} unmatched LoRA keys")

    # -- generation -------------------------------------------------------

    def generate(self, settings: Dict[str, Any],
                 on_progress: Optional[Callable] = None) -> List[str]:
        """Run one task; returns the list of output file paths."""
        s = self._apply_presets(dict(settings))
        model_type = s.get("model_type") or "t2v_1.3B"
        defaults = self.registry.default_settings(model_type)
        model_def = self.registry.get(model_type)
        merged = {**defaults, **s, "model_type": model_type}
        seed = int(merged.get("seed", -1))
        if seed < 0:
            seed = random.randint(0, 2 ** 31 - 1)
            merged["seed"] = seed
        requested = merged.get("resolution", "832x480")
        merged["resolution"] = resolve_resolution(model_def, requested) \
            or requested
        width, height = parse_resolution(merged["resolution"])

        # what the family does not run raises here, before any work
        check = getattr(self.registry.handler_for(model_type),
                        "check_request", None)
        if check is not None:
            check(self.registry.base_model_type(model_type), model_def,
                  merged, from_files=not self.init_random_weights)
        plan = self.lora_plan(merged)
        pipe = self.get_pipeline(model_type, model_def=model_def)
        self.sync_loras(model_type, pipe, plan, on_progress)
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

    def _apply_presets(self, s: Dict[str, Any]) -> Dict[str, Any]:
        """The request's `profile` and `lset_name` underlaid (a profile's
        keys under the request's; a preset's LoRAs before its own)."""
        from ..config.profiles import apply_lset, apply_profile, \
            list_profiles
        profile = s.pop("profile", None)
        if profile:
            if "/" in profile:
                fam, name = profile.split("/", 1)
            else:
                fam = next((f for f, names in list_profiles().items()
                            if profile in names), None)
                name = profile
            if fam is None:
                raise FileNotFoundError(f"profile {profile!r} not found")
            s = apply_profile(s, fam, name)
        lset = s.pop("lset_name", None)
        if lset:
            if not os.path.isfile(lset):
                lset = os.path.join(
                    s.get("lora_dir", self.lora_root),
                    lset if lset.endswith(".lset") else lset + ".lset")
            s = apply_lset(s, lset)
        return s

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
