"""Batched serving launcher: continuous decode over a request queue (the
port of the reference's ``launch/serve.py``).

Fixed-size batch slots, each slot holds an independent request; finished
slots are refilled from the queue (continuous batching). The KV cache is
allocated once at ``--max-seq`` and reused across requests.

The loop keeps the reference's behaviour so that the returned dicts
agree: after a request's first token each slot is fed its own greedy
prediction (not the prompt's later tokens), a refilled slot's cache rows
are not cleared, the cache index is shared by every slot (the loop stops
at ``max_seq - 1`` steps), and ``tok_per_s`` counts only the tokens of
finished requests.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --requests 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import model as M


def serve(cfg, *, batch_slots: int, max_seq: int, n_requests: int,
          prompt_len: int, max_new: int, seed: int = 0,
          device="cuda") -> dict:
    params = M.init_params(cfg, seed=seed, device=device)
    dev = params["embed"].device

    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
             for _ in range(n_requests)]
    done = []
    cache = M.init_cache(cfg, batch_slots, max_seq, device=dev)
    # per-slot progress bookkeeping (host side)
    slot_tokens = np.zeros((batch_slots,), np.int64)
    slot_left = np.zeros((batch_slots,), np.int64)
    cur = np.zeros((batch_slots, 1), np.int64)

    def refill():
        for s in range(batch_slots):
            if slot_left[s] == 0 and queue:
                prompt = queue.pop()
                cur[s, 0] = prompt[0]
                slot_left[s] = len(prompt) - 1 + max_new
                slot_tokens[s] = 0

    refill()
    t0 = time.perf_counter()
    steps = 0
    while np.any(slot_left > 0):
        logits, cache = M.decode_step(params, torch.from_numpy(cur).to(dev),
                                      cache, cfg)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        for s in range(batch_slots):
            if slot_left[s] > 0:
                cur[s, 0] = nxt[s]
                slot_left[s] -= 1
                slot_tokens[s] += 1
                if slot_left[s] == 0:
                    done.append(int(slot_tokens[s]))
        steps += 1
        refill()
        if steps >= max_seq - 1:
            break
    dt = time.perf_counter() - t0
    total = int(np.sum(slot_tokens)) + sum(done) if not done else sum(done)
    return {"requests_done": len(done), "decode_steps": steps,
            "tok_per_s": total / dt if dt > 0 else 0.0,
            "wall_s": dt}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="yi-9b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cfg = get_config(args.arch).reduced()
    out = serve(cfg, batch_slots=args.slots, max_seq=args.max_seq,
                n_requests=args.requests, prompt_len=args.prompt_len,
                max_new=args.max_new, device=args.device)
    print(out)


if __name__ == "__main__":
    main()
