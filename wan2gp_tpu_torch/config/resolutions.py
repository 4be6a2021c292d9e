"""Resolution governance (the part of wan2gp_tpu/config/resolutions.py
the t2v service needs): requests are floor-aligned to the VAE/patch block.
Models that declare resolution buckets are not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple


def parse_resolution(value: str) -> Tuple[int, int]:
    w, h = value.lower().split("x", 1)
    return int(w), int(h)


def align_dim(value: int, block: int) -> int:
    """Floor-align to the block, never below one block."""
    if block <= 1:
        return value
    return max(block, value // block * block)


def align_resolution(resolution: str, block: int) -> str:
    w, h = parse_resolution(resolution)
    return f"{align_dim(w, block)}x{align_dim(h, block)}"


def resolve_resolution(model_def: dict, requested: Optional[str],
                       block_size: Optional[int] = None) -> Optional[str]:
    """Final per-task resolution: block-aligned as requested."""
    if "resolutions" in model_def or "resolutions_categories" in model_def:
        raise NotImplementedError(
            "resolution buckets are not ported yet (ROADMAP Queue 1)")
    if requested is None:
        return None
    block = (model_def.get("vae_block_size", 16)
             if block_size is None else block_size)
    return align_resolution(requested, int(block)) if block else requested
