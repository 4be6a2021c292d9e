"""Checkpoint location: URL-variant selection and a multi-root locator.

Counterpart of wan2gp_tpu/io/downloads.py (stdlib only) without its
downloader: the port finds checkpoint files that are already on disk and
raises for a file it cannot find, naming the file and the roots searched.
`resolve_lora_file` finds a LoRA that a request or a profile names by URL
(the JAX service hands the URL to its reader as a path).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence


def pick_checkpoint_url(urls: Sequence[str], quantization: str = "",
                        dtype_policy: str = "bf16") -> str:
    """Choose among URL variants by quantization/dtype markers in the
    filename (int8/fp8 quant tags, mbf16/mfp16 dtype tags; falls back to
    the first URL)."""
    if not urls:
        raise ValueError("no URLs")

    def has(name, *tags):
        low = os.path.basename(name).lower()
        return all(t in low for t in tags)

    if quantization:
        for u in urls:
            if has(u, f"_{quantization}") or has(u, quantization):
                if dtype_policy and has(u, dtype_policy):
                    return u
        for u in urls:
            if has(u, quantization):
                return u
    for u in urls:
        if dtype_policy and has(u, f"m{dtype_policy}") \
                and not has(u, "int8") and not has(u, "fp8"):
            return u
    for u in urls:
        if not has(u, "int8") and not has(u, "fp8") and not has(u, "int4"):
            return u
    return urls[0]


def expand_sharded_index(index_path: str) -> List[str]:
    """A `*.safetensors.index.json` names its shards in `weight_map`;
    returns the shards' paths beside the index, in name order.  Raises
    FileNotFoundError for a shard that is not there."""
    with open(index_path) as f:
        index = json.load(f)
    shard_names = sorted(set((index.get("weight_map") or {}).values()))
    out_dir = os.path.dirname(index_path)
    paths = []
    for name in shard_names:
        local = os.path.join(out_dir, name)
        if not os.path.exists(local):
            raise FileNotFoundError(
                f"shard {name!r} of {index_path} is not on disk")
        paths.append(local)
    return paths


class FileLocator:
    """Multi-root checkpoint resolution: the first root holding the file
    wins."""

    def __init__(self, roots: Optional[List[str]] = None):
        self.roots = roots or ["ckpts"]

    def locate(self, filename: str) -> Optional[str]:
        for root in self.roots:
            p = os.path.join(root, filename)
            if os.path.exists(p):
                return p
        return None

    def ensure(self, url: str, subdir: str = "") -> str:
        """The local path of the URL's file; a `*.safetensors.index.json`
        also checks its shards.  Raises FileNotFoundError when it is
        missing (this package downloads nothing)."""
        filename = os.path.basename(url.split("?")[0])
        rel = os.path.join(subdir, filename) if subdir else filename
        found = self.locate(rel)
        if found is None:
            raise FileNotFoundError(
                f"checkpoint {rel!r} is not in any of {self.roots}")
        if filename.endswith(".index.json"):
            expand_sharded_index(found)
        return found


def make_checkpoints_resolver(roots: Optional[List[str]] = None,
                              quantization: str = "",
                              dtype_policy: str = "bf16",
                              roles: Optional[Sequence[str]] = None,
                              names: Optional[Dict[str, str]] = None):
    """checkpoints_resolver for GenerationService: locates the file of
    every role a handler declares through query_model_files (under the
    spec's `subdir` of a root where it names one: wav2vec2's
    `model.safetensors` sits in its own folder; the JAX resolver looks for
    every file at a root's top); a missing file raises.  roles: resolve only these (None: every declared role);
    the handler then loads the model without the others.  names: {role:
    file name} looked for in place of the role's URLs (a role that lists
    no URL, such as Qwen-Image's text tower, is resolved only so)."""
    locator = FileLocator(roots)
    names = dict(names or {})

    def resolve(model_type, handler, base_model_type, model_def):
        out: Dict[str, str] = {}
        for spec in handler.query_model_files(base_model_type, model_def):
            role = spec["role"]
            urls = [names[role]] if role in names else spec.get("urls") or []
            if not urls or (roles is not None and role not in roles):
                continue
            url = pick_checkpoint_url(urls, quantization, dtype_policy)
            out[role] = locator.ensure(url, spec.get("subdir", ""))
        return out

    return resolve


def lora_dirs(lora_root: str, model_type: str = "",
              family: str = "") -> List[str]:
    """The folders a LoRA is looked for in, in `discover_loras`'s order:
    <root>/<family>/<model_type>, <root>/<family>, <root>/<model_type>,
    <root>."""
    dirs = []
    if family:
        if model_type:
            dirs.append(os.path.join(lora_root, family, model_type))
        dirs.append(os.path.join(lora_root, family))
    if model_type:
        dirs.append(os.path.join(lora_root, model_type))
    return dirs + [lora_root]


def resolve_lora_file(name: str, lora_root: str, model_type: str = "",
                      family: str = "") -> str:
    """The local path of a LoRA named by a path, a name relative to the
    LoRA folders, or a URL (looked for by its basename) in the folders of
    `lora_dirs`.  Raises FileNotFoundError naming the file and the folders
    searched: nothing is downloaded."""
    if "://" not in name and os.path.isfile(name):
        return name
    rel = os.path.basename(name.split("?")[0]) if "://" in name else name
    dirs = lora_dirs(lora_root, model_type, family)
    for d in dirs:
        path = os.path.join(d, rel)
        if os.path.isfile(path):
            return path
    raise FileNotFoundError(
        f"LoRA file {rel!r} is not in any of {dirs} (this package "
        "downloads nothing)")
