"""Headless CLI of the PyTorch/CUDA port.

Usage:
  python -m wan2gp_tpu_torch --model t2v_1.3B --prompt "a cat" --random-weights
  python -m wan2gp_tpu_torch --checkpoints-dir ckpts --process settings.json
  python -m wan2gp_tpu_torch --model krea2_raw --prompt "a cat" \
      --random-weights --resolution 1024x1024 --steps 28
  python -m wan2gp_tpu_torch --model flux_schnell --prompt "a cat" \
      --random-weights --quantize int8
  python -m wan2gp_tpu_torch --process queue.json
  python -m wan2gp_tpu_torch --list-models

Runs on the GPU unless `--device cpu` is given.
Exit codes: 0 success, 1 task error, 130 interrupted.
"""
from __future__ import annotations

import argparse
import sys

from ..io.downloads import make_checkpoints_resolver
from .queue import TaskQueue
from .service import GenerationService


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("wan2gp_tpu_torch",
                                description="Wan video and Krea 2 image "
                                            "generation on PyTorch/CUDA")
    p.add_argument("--process", metavar="QUEUE",
                   help="headless: process a queue .json and exit")
    p.add_argument("--dry-run", action="store_true",
                   help="validate the queue without generating")
    p.add_argument("--list-models", action="store_true")
    p.add_argument("--model", default=None,
                   help="model type for one-shot (t2v_1.3B, t2v, krea2_raw, "
                        "krea2_turbo, flux_schnell, flux_dev; see "
                        "--list-models)")
    p.add_argument("--prompt", default=None)
    p.add_argument("--negative-prompt", default="")
    p.add_argument("--resolution", default=None,
                   help="e.g. 832x480 (Wan), 1024x1024 (Krea 2) or "
                        "1280x720 (Flux)")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--guidance-scale", type=float, default=None)
    p.add_argument("--flow-shift", type=float, default=None)
    p.add_argument("--solver", default=None,
                   choices=["unipc", "dpm++", "euler", "causvid", "lcm"])
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--output-dir", default="outputs")
    p.add_argument("--attention", default="auto",
                   help="attention mode: auto | pallas | xla (dense) | "
                        "sol[:tau[:budget[:thresh_type]]] (Sol-Attn) | "
                        "radial (radial block mask from the latent grid) | "
                        "swa:<window_blocks>[:<sink_blocks>]")
    p.add_argument("--quantize", default="",
                   choices=["", "int8", "int4", "int8a8", "int4a8"],
                   help="quantize the transformer's block linears on load: "
                        "int8 or int4 weights; int8a8 / int4a8 also run "
                        "int8 activations (Wan; Flux takes int8 and int4, "
                        "Krea 2 none of them)")
    p.add_argument("--random-weights", action="store_true",
                   help="run with randomly initialized weights")
    p.add_argument("--checkpoints-dir", default="ckpts",
                   help="directory holding the checkpoint files of each "
                        "model (file names as in the model definitions' "
                        "URLs); unused with --random-weights")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "PyTorch versions of the kernels)")
    p.add_argument("--verbose", type=int, default=1)
    return p


def _settings_from_args(args) -> dict:
    s = {"model_type": args.model or "t2v_1.3B", "seed": args.seed}
    for key, value in (("prompt", args.prompt),
                       ("resolution", args.resolution),
                       ("video_length", args.frames),
                       ("num_inference_steps", args.steps),
                       ("guidance_scale", args.guidance_scale),
                       ("flow_shift", args.flow_shift),
                       ("sample_solver", args.solver)):
        if value is not None:
            s[key] = value
    if args.negative_prompt:
        s["negative_prompt"] = args.negative_prompt
    return s


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    service = GenerationService(
        output_dir=args.output_dir, attn_backend=args.attention,
        init_random_weights=args.random_weights,
        checkpoints_resolver=(None if args.random_weights else
                              make_checkpoints_resolver(
                                  [args.checkpoints_dir])),
        quantize=args.quantize, device=args.device)
    if args.list_models:
        for mt in service.registry.model_types():
            print(f"{mt:24s} {service.registry.get(mt).get('name', '')}")
        return 0

    q = TaskQueue()
    if args.process:
        q.load(args.process)
        if args.dry_run:
            errors = 0
            for t in q.tasks():
                mt = t.settings.get("model_type", "t2v_1.3B")
                if mt not in service.registry.models_def:
                    print(f"task {t.id}: unknown model_type {mt!r}")
                    errors += 1
            print(f"{len(q.tasks())} task(s), {errors} error(s)")
            return 1 if errors else 0
    else:
        if args.prompt is None and not args.random_weights:
            print("nothing to do: pass --prompt / --process / --list-models")
            return 0
        q.add(_settings_from_args(args))

    def on_event(kind, data):
        if args.verbose < 1:
            return
        if kind == "task_start":
            print(f"[task {data.id}] start: "
                  f"{data.settings.get('model_type')}")
        elif kind == "task_done":
            print(f"[task {data.id}] done -> {', '.join(data.outputs)}")
        elif kind == "task_error":
            print(f"[task {data.id}] ERROR: {data.error}", file=sys.stderr)
        elif kind == "status":
            print(f"  {data}")

    try:
        return service.process_queue(q, on_event=on_event)
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
