"""Fault-tolerant training driver, end to end (the port of the reference's
``launch/train.py``).

  - auto-resume: picks up the latest checkpoint (params + optimizer +
    step + data cursor), so a restart after a kill continues the exact
    token stream;
  - periodic atomic checkpoints (train/checkpoint.py) and a final one;
  - straggler watchdog: a step longer than ``step_timeout_s`` is logged
    and counted (the decision layer that acts on such failures is
    ``repro_torch.distributed.fault_tolerance``);
  - optional mesh: with a ``DeviceMesh`` (``launch/mesh.py``) the same
    loop runs sharded by the production rules
    (``distributed/sharding.py``): a fresh state is placed by
    ``param_shardings``, a resumed one restored onto the mesh by
    ``restore(shardings=...)``, each batch placed by
    ``batch_shardings``; every rank of the mesh runs the loop.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b --smoke \\
      --steps 200 --ckpt-dir /tmp/ckpt [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Optional

from repro_torch import resolve_device
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import sharding as S
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import train_step as TS
from repro_torch.train.data import DataConfig, batch_at
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state


@dataclasses.dataclass
class RunConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    step_timeout_s: float = 300.0


def _template(cfg) -> TS.TrainState:
    """The train state's structure on the meta device (no memory)."""
    params = M.empty_params(cfg, device="meta").requires_grad_()
    return TS.TrainState(params=params, opt=init_opt_state(params))


def train_loop(cfg, data_cfg: DataConfig, opt_cfg: OptimizerConfig,
               run: RunConfig, *, mesh=None, log=print,
               device="cuda") -> dict:
    """Train ``run.steps`` steps, resuming from ``run.ckpt_dir``'s latest
    checkpoint if there is one. With ``mesh`` the device is the mesh's
    and ``device`` is not read."""
    step_fn = TS.make_train_step(cfg, opt_cfg, mesh)
    dev = resolve_device(mesh.device_type if mesh is not None else device)

    start_step = 0
    state = None
    if run.ckpt_dir and ckpt.latest_step(run.ckpt_dir) is not None:
        template = _template(cfg)
        shardings = None if mesh is None else S.param_shardings(template,
                                                                  mesh)
        state, start_step, meta = ckpt.restore(run.ckpt_dir, template,
                                               device=dev,
                                               shardings=shardings)
        log(f"[resume] restored step {start_step} "
            f"(loss was {meta.get('loss', '?')})")
    if state is None and mesh is None:
        state = TS.init_train_state(cfg, seed=data_cfg.seed, device=dev)
    elif state is None:
        state = TS.init_train_state(cfg, seed=data_cfg.seed, device=dev,
                                    mesh=mesh)

    history = []
    stragglers = 0
    last_loss = float("nan")
    for step in range(start_step, run.steps):
        t0 = time.time()
        batch = batch_at(data_cfg, step, device=dev)
        if mesh is not None:
            batch = S.distribute(batch, S.batch_shardings(batch, mesh))
        state, metrics = step_fn(state, batch)
        dt = time.time() - t0
        if dt > run.step_timeout_s:
            stragglers += 1
            log(f"[watchdog] step {step} took {dt:.1f}s "
                f"(> {run.step_timeout_s}s) — straggler #{stragglers}")
        last_loss = float(metrics["loss"])
        if step % run.log_every == 0 or step == run.steps - 1:
            log(f"step {step:5d} loss {last_loss:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"lr {float(metrics['lr']):.2e} {dt * 1e3:.0f}ms")
        history.append(last_loss)
        if run.ckpt_dir and (step + 1) % run.ckpt_every == 0:
            ckpt.save(run.ckpt_dir, step + 1, state,
                      metadata={"loss": last_loss, "arch": cfg.name})
    if run.ckpt_dir:
        ckpt.save(run.ckpt_dir, run.steps, state,
                  metadata={"loss": last_loss, "arch": cfg.name})
    return {"final_loss": last_loss, "history": history,
            "stragglers": stragglers, "state": state}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    data_cfg = DataConfig(batch_size=args.batch, seq_len=args.seq,
                          vocab_size=cfg.vocab_size)
    opt_cfg = OptimizerConfig(total_steps=args.steps,
                              warmup_steps=max(args.steps // 20, 1))
    run = RunConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                    ckpt_dir=args.ckpt_dir)
    out = train_loop(cfg, data_cfg, opt_cfg, run, device=args.device)
    print(json.dumps({"final_loss": out["final_loss"],
                      "stragglers": out["stragglers"]}))


if __name__ == "__main__":
    main()
