"""Training launcher (port of ``repro/launch/train.py``): ``--arch`` picks
the architecture, ``--full`` its published config (else the reduced smoke
config of the same family), ``--layers`` cuts its depth.  It runs on the
CUDA card unless ``--device cpu`` is given (the plain versions of the
kernels).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --full --steps 8 --batch 8 --seq 1024
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \\
      --device cpu --steps 2 --batch 2 --seq 24
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch llama4-maverick-400b-a17b --full --layers 8 --steps 3 \\
      --batch 8 --seq 1024

Every arch trains: the MoE archs with their load-balancing loss, the
windowed, recurrent and xLSTM blocks, and whisper's encoder-decoder on the
data's stub frames.  ``--metrics-out FILE`` streams the trainer's ``obs``
registry snapshots (``train.loss``, ``train.step_s``,
``train.tokens_per_s``, ...) to FILE as JSONL every ``--metrics-every``
steps and once at the end; ``python -m repro_torch.obs --validate FILE``
checks it.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

from ..configs.registry import ARCH_IDS, get_config, get_smoke_config
from ..data.pipeline import SyntheticLM
from ..obs import Obs
from ..optim import adamw
from ..train.trainer import Trainer


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_IDS))
    ap.add_argument("--full", action="store_true",
                    help="the published config")
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many (decoder) layers")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--bayesian", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--workdir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"))
    ap.add_argument("--metrics-out", default=None, metavar="FILE",
                    help="write obs JSONL telemetry (train.loss / "
                         "train.step_s / train.tokens_per_s snapshots) to "
                         "FILE; the heartbeat file is unaffected")
    ap.add_argument("--metrics-every", type=int, default=10,
                    help="with --metrics-out: flush every N steps")
    ap.add_argument("--log-every", type=int, default=10,
                    help="print (and keep in the history) every N steps")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint every N steps and at the end (default "
                         "steps // 2; 0: no checkpoints)")
    args = ap.parse_args(argv)

    getter = get_config if args.full else get_smoke_config
    cfg = getter(args.arch, compress=not args.no_compress)
    if args.layers is not None:
        cfg = cfg.replace(num_layers=args.layers)
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq, seed=0)
    obs = Obs(emit_path=args.metrics_out, emit_every=args.metrics_every)
    trainer = Trainer(
        cfg,
        adamw.AdamWConfig(lr=args.lr, quantize_moments=args.int8_moments),
        workdir=args.workdir, data_fn=data, total_steps=args.steps,
        ckpt_every=(max(args.steps // 2, 1) if args.ckpt_every is None
                    else args.ckpt_every), log_every=args.log_every,
        accum=args.accum,
        compress_grads=args.compress_grads, bayesian_mode=args.bayesian,
        obs=obs, device=args.device)
    state = trainer.run()
    n = sum(p.numel() for p in state["model"].parameters())
    loss = (f"{trainer.history[-1]['loss']:.4f}" if trainer.history
            else "n/a")
    print(f"[launch.train] {args.arch} on {trainer.device}: "
          f"{int(state['step'])} steps, {n:,} params, loss {loss}, "
          f"skipped {int(state['skipped'])}", flush=True)
    if args.metrics_out is not None:
        obs.close()                         # the final cumulative snapshot
        print(f"[launch.train] metrics: {obs.emitter.lines_written} "
              f"lines -> {args.metrics_out}", flush=True)
    return {"state": state, "history": trainer.history,
            "registry": trainer.registry, "obs": obs}


if __name__ == "__main__":
    main()
