"""Settings profiles and LoRA presets.

Copy of wan2gp_tpu/config/profiles.py (stdlib only), over the profile JSONs
copied into `config/profiles/` for the families the port runs:
- profiles/<family>/*.json: named settings presets (LoRA-accelerator URLs,
  step counts, guidance/shift overrides) merged UNDER task settings;
- .lset files: small LoRA presets beside the LoRA folder with keys
  {"loras": [...], "loras_mult": "...", "prompt": "", "full_prompt": bool}.
A profile names its LoRAs by URL; `io.downloads.resolve_lora_file` finds
each one on disk by its basename (nothing is downloaded).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_PKG_PROFILES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "profiles")


def profile_dirs(extra_root: Optional[str] = None) -> List[str]:
    dirs = [_PKG_PROFILES]
    if extra_root:
        dirs.insert(0, extra_root)
    return [d for d in dirs if os.path.isdir(d)]


def list_profiles(family: Optional[str] = None,
                  extra_root: Optional[str] = None) -> Dict[str, List[str]]:
    """{family: [profile names]} across profile roots."""
    out: Dict[str, List[str]] = {}
    for root in profile_dirs(extra_root):
        for fam in sorted(os.listdir(root)):
            fdir = os.path.join(root, fam)
            if not os.path.isdir(fdir):
                continue
            if family is not None and fam != family:
                continue
            names = [f[:-5] for f in sorted(os.listdir(fdir))
                     if f.endswith(".json")]
            out.setdefault(fam, [])
            out[fam] += [n for n in names if n not in out[fam]]
    return out


def load_profile(family: str, name: str,
                 extra_root: Optional[str] = None) -> Dict[str, Any]:
    for root in profile_dirs(extra_root):
        path = os.path.join(root, family, name + ".json")
        if os.path.isfile(path):
            with open(path, encoding="utf-8") as f:
                return json.load(f)
    raise FileNotFoundError(f"profile {family}/{name} not found")


def apply_profile(settings: Dict[str, Any], family: str, name: str,
                  extra_root: Optional[str] = None) -> Dict[str, Any]:
    """Profile keys underlay the task settings (task keys win)."""
    prof = load_profile(family, name, extra_root)
    return {**prof, **settings}


def discover_loras(lora_root: str, model_type: str = "",
                   family: str = "") -> Dict[str, List[str]]:
    """Per-model LoRA directory scan (wgp.py:3706 setup_loras +
    get_lora_dir:2437): recursively glob *.safetensors/*.sft under
    <lora_root>[/<family>[/<model_type>]], plus *.lset/*.json/*.zip
    presets at the top of that dir.  Returns {"loras": [...],
    "presets": [...]} with paths relative to the chosen dir."""
    import glob as _glob
    from ..io.downloads import lora_dirs
    lora_dir = next((d for d in lora_dirs(lora_root, model_type, family)
                     if os.path.isdir(d)), lora_root)
    loras = sorted(
        _glob.glob(os.path.join(lora_dir, "**", "*.safetensors"),
                   recursive=True)
        + _glob.glob(os.path.join(lora_dir, "**", "*.sft"),
                     recursive=True),
        key=lambda p: os.path.relpath(p, lora_dir).casefold())
    presets = sorted(
        _glob.glob(os.path.join(lora_dir, "*.lset"))
        + _glob.glob(os.path.join(lora_dir, "*.json"))
        + _glob.glob(os.path.join(lora_dir, "*.zip")))
    return {"dir": lora_dir,
            "loras": [os.path.relpath(p, lora_dir) for p in loras],
            "presets": [os.path.basename(p) for p in presets]}


def load_lset(path: str) -> Dict[str, Any]:
    """Read a .lset LoRA preset (wgp.py:3695-3703).  Returns
    {"loras": [...], "loras_multipliers": str, "prompt": str,
     "full_prompt": bool}."""
    with open(path, encoding="utf-8") as f:
        lset = json.load(f)
    return {
        "loras": lset.get("loras", []),
        "loras_multipliers": lset.get("loras_mult", ""),
        "prompt": lset.get("prompt", ""),
        "full_prompt": bool(lset.get("full_prompt", False)),
    }


def save_lset(path: str, loras: List[str], loras_mult: str = "",
              prompt: str = "", full_prompt: bool = False):
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"loras": loras, "loras_mult": loras_mult,
                   "prompt": prompt, "full_prompt": full_prompt}, f,
                  indent=1)


def apply_lset(settings: Dict[str, Any], lset_path: str) -> Dict[str, Any]:
    """Merge a .lset into task settings: the preset's LoRAs prepend the
    task's, its multipliers string replaces unset ones, and the preset
    prompt is either the full prompt or a prefix (full_prompt flag,
    wgp.py apply-lset semantics)."""
    lset = load_lset(lset_path)
    out = dict(settings)
    out["loras"] = list(lset["loras"]) + list(settings.get("loras") or [])
    if lset["loras_multipliers"]:
        base = settings.get("loras_multipliers", "")
        out["loras_multipliers"] = (lset["loras_multipliers"] +
                                    (" " + base if base else ""))
    if lset["prompt"]:
        if lset["full_prompt"]:
            out["prompt"] = lset["prompt"]
        else:
            out["prompt"] = lset["prompt"] + " " + settings.get("prompt", "")
    return out
