"""LM training on the PyTorch/CUDA port (any --arch from the zoo).

The reduced configs run anywhere; the full configs at world 1 fit the card
for the small archs (``python -m repro_torch.launch.dryrun`` sizes the
rest).  Demonstrates the fault-tolerant trainer: kill it mid-run and rerun
the same command — it resumes.

    PYTHONPATH=src python examples_torch/train_lm.py --arch olmo-1b --steps 100
    PYTHONPATH=src python examples_torch/train_lm.py --arch olmo-1b --size 100m --steps 200
    PYTHONPATH=src python examples_torch/train_lm.py --arch olmo-1b --steps 10 --device cpu
"""

import argparse
import dataclasses

import torch

from repro_torch import configs
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.optim import Adam, cosine_warmup
from repro_torch.train.train_step import make_train_step
from repro_torch.train.trainer import Trainer


def build_config(arch: str, size: str):
    if size == "smoke":
        return configs.get_smoke_config(arch)
    if size == "100m":
        # ~100M-parameter variant of the chosen family
        base = configs.get_smoke_config(arch)
        return dataclasses.replace(
            base,
            n_layers=max(8, len(base.pattern) * 4),
            d_model=512,
            n_heads=8,
            n_kv_heads=min(8, max(base.n_kv_heads, 2)),
            head_dim=64,
            d_ff=2048 if base.d_ff else 0,
            moe_d_ff=512 if base.n_experts else 0,
            vocab_size=32768,
            rnn_width=512 if base.rnn_width else None,
        )
    return configs.get_config(arch)


def train(cfg, *, steps=100, batch=8, seq=128, lr=3e-4, ckpt_dir=None, ckpt_every=50, device="cuda",
          params=None, log=print) -> dict:
    """Train ``cfg`` from seeded weights (or ``params``, a model on ``device``); returns the trainer's numbers.

    ``log`` takes every line the run prints, the trainer's too.
    """
    dev = resolve_device(device)
    params = tf.init_model(cfg, 0, dev) if params is None else params
    opt = Adam(learning_rate=cosine_warmup(lr, steps // 10, steps))
    step_fn, _ = make_train_step(cfg, opt, donate=False)

    def data_fn(step):
        t, l = next(token_batches(cfg.vocab_size, batch, seq, seed=step))
        return torch.from_numpy(t).long().to(dev), torch.from_numpy(l).long().to(dev)

    trainer = Trainer(
        step_fn, params, opt.init(params), data_fn,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, log_every=10, log_fn=log,
    )
    rep = trainer.run(steps)
    log(
        f"done: {rep.steps} steps, loss {rep.losses[0]:.4f} -> {rep.last_loss:.4f}, "
        f"median step {rep.median_step_time()*1e3:.1f} ms, "
        f"stragglers {rep.stragglers}"
    )
    return dict(steps=rep.steps, losses=list(rep.losses), step_times_s=list(rep.step_times),
                median_step_s=rep.median_step_time(), stragglers=rep.stragglers, resumed_from=rep.resumed_from,
                model=trainer.params)


def run(arch="olmo-1b", size="smoke", *, device="cuda", log=print, **kw) -> dict:
    """The command line's run: ``kw`` are :func:`train`'s (steps, batch, seq, lr, ckpt_dir, ckpt_every)."""
    cfg = build_config(arch, size)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{arch} takes stub embeddings; use the dry-run for it")
    resolve_device(device)
    log(f"arch={cfg.name} params≈{cfg.param_count()/1e6:.1f}M "
        f"(active {cfg.active_param_count()/1e6:.1f}M)")
    return train(cfg, device=device, log=log, **kw)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=list(configs.ARCH_IDS))
    ap.add_argument("--size", default="smoke", choices=["smoke", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args()
    run(args.arch, args.size, device=args.device, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)


if __name__ == "__main__":
    main()
