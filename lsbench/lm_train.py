"""Training: the port's train step, step after step, on batches drawn from
the seed.

The configuration's ``arch`` object holds the port's ``ArchConfig``
fields by name, ``reference`` names its plain reference
(``reference/<reference>.py``), and the mix (kind ``lm_train``) gives:

- ``seq_len`` and ``sequences_per_step``: each step's batch, rows of
  ``seq_len + 1`` token ids drawn uniformly over the vocabulary from the
  seed and the step's index (the ids, and the next ids as labels);
- ``warmup_steps``: untimed steps before the window, ``check_steps`` of
  them (at least one) recorded for the check;
- ``trace_steps``: steps traced after the window with ``--trace 1``;
- ``optimizer``: the nine fields of the port's ``OptimizerConfig``, all
  of them (the reference's optimizer has no defaults).

Set-up builds one training state with the program's entries,
``train_step.init_train_state(cfg, seed=...)`` and
``make_train_step(cfg, OptimizerConfig(...))``, and writes the
benchmark's own draw of the weights (``weights``) into its parameters,
so that the reference starts from the same numbers. The warm-up runs
that state: of its first ``check_steps`` steps it records each step's
``loss`` and ``grad_norm``, after the first the norm of each leaf's
gradient as the optimizer took it (the first moment over ``1 - b1``),
and after the last the norm of each leaf's change. The same state then
steps through the window, each step timed on the host clock from its
call to the ``torch.cuda.synchronize()`` after it, until ``--seconds``
have passed. ``tokens_per_s`` is the tokens of the window's steps over
the time from the first one's call to the last one's synchronize: whole
steps, since one may take seconds. Its entry in ``BENCHMARK.json`` lists
the training cells that report it; ``reporting`` adds a probe's or a
test's cell made in memory to that list.

The check (``numbers``), once the program's state is freed: the
configuration's reference (``loss_and_grads``) and plain AdamW
(``reference/adamw.py``) follow the same ``check_steps`` steps in
float32 from the same draw and the same batches, each weight rounded
after each update to the dtype ``arch["dtype"]`` states (a bfloat16
weight moves only by whole steps of its precision: a norm's scale of 1
does not move under an update below 2^-9, on either side). The numbers:

- ``loss_rel``: the largest relative gap of a step's loss;
- ``grad_norm_rel``: the largest relative gap of a step's gradient norm
  (before clipping);
- ``grad_rel``: over the leaves, the gap between the norms of the first
  step's gradient as the optimizer took it (clipped), over the
  reference leaf's norm or the median leaf's, whichever is larger;
- ``update_rel``: the same of each leaf's change after ``check_steps``
  steps, leaving out leaves whose first gradient in the reference is
  under a thousandth of the median leaf's (they move by round-off
  alone);
- ``leaves_below_dtype``: the program's leaves stored in a coarser dtype
  than ``arch["dtype"]`` states (the reference stores what it states, so
  such a leaf is a departure, not a rounding both sides share).

``control`` puts the reference, computed one precision below the one
``arch["dtype"]`` states, in the program's place (``lsbench.calibrate``).
"""
from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from lsbench import devtrace, harness, peaks
from lsbench.reference import adamw

# The precision one step below each a configuration may state.
CONTROL = {"float64": "float32", "float32": "tf32", "bfloat16": "float8"}
SMALL = 0.02        # standard deviation of the embedding and the router
LEAF_FLOOR = 1e-3   # leaves under this share of the median leaf's gradient
WEIGHTS, BATCHES = 1, 2


def reporting(bench: dict, workload: str) -> dict:
    """``bench`` with ``workload`` (a probe's or a test's cell made in
    memory) among the cells that report ``tokens_per_s``."""
    entry = next(m for m in bench["end_to_end"]
                 if m["name"] == "tokens_per_s")
    entry["workloads"] = entry["workloads"] + [workload]
    return bench


def _stream(seed: int, *tags: int) -> int:
    """A generator seed for one draw of the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 63, *tags]).generate_state(
        1, np.uint64)[0]
    return int(state >> np.uint64(1))


def scale(name: str, shape: Tuple[int, ...]):
    """The standard deviation of leaf ``name``'s draw: ones for a vector,
    ``SMALL`` for the embedding and the router, else one over the root of
    the inputs a product sums over (heads x head size for ``wo``, the
    input width of a stack of experts (E, in, out), the first dim
    otherwise)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        return None
    if leaf in ("embed", "router"):
        return SMALL
    if leaf == "wo" and len(shape) == 3:
        fan = shape[0] * shape[1]
    elif ".moe." in name and len(shape) == 3:
        fan = shape[1]
    else:
        fan = shape[0]
    return fan ** -0.5


def weights(layout, seed: int, device) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, tensor) of the benchmark's draw of each leaf of ``layout``
    ((name, shape, dtype) in the program's order), each from its own
    generator on ``device``, rounded to the leaf's dtype."""
    for i, (name, shape, dtype) in enumerate(layout):
        std = scale(name, shape)
        if std is None:
            w = torch.ones(shape, device=device)
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(_stream(seed, WEIGHTS, i))
            w = torch.randn(shape, generator=gen, device=device) * std
        yield name, w.to(dtype)


def batch(seed: int, step: int, mix: dict, vocab: int, device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream(seed, BATCHES, step))
    ids = torch.randint(0, vocab, (int(mix["sequences_per_step"]),
                                   int(mix["seq_len"]) + 1),
                        generator=gen, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


@torch.no_grad()
def change_norms(params: Dict[str, torch.Tensor], layout, seed: int,
                 device) -> Dict[str, float]:
    """Each leaf's norm of ``params`` less the benchmark's draw."""
    return {name: float(torch.linalg.vector_norm(
        params[name].float() - w.float()))
        for name, w in weights(layout, seed, device)}


def run(cell) -> dict:
    from repro_torch.configs.base import ArchConfig
    from repro_torch.obs.trace import annotate
    from repro_torch.train import train_step as T
    from repro_torch.train.optimizer import OptimizerConfig
    mix, dev = cell.mix, cell.device
    cfg = ArchConfig(**cell.config["arch"])
    opt = OptimizerConfig(**mix["optimizer"])
    n_check, n_warm = int(mix["check_steps"]), int(mix["warmup_steps"])
    if not 1 <= n_check <= n_warm:
        raise ValueError("the mix needs 1 <= check_steps <= warmup_steps")
    state = T.init_train_state(cfg, seed=cell.seed, device=dev)
    params = dict(state.params.named_parameters())
    layout = [(k, tuple(p.shape), p.dtype) for k, p in params.items()]
    with torch.no_grad():
        for name, w in weights(layout, cell.seed, dev):
            params[name].copy_(w)
    step = T.make_train_step(cfg, opt)
    cell.mark("state")

    def draw(i):
        return batch(cell.seed, i, mix, cfg.vocab_size, dev)

    record: dict = dict(loss=[], grad_norm=[])
    for i in range(n_warm):
        state, metrics = step(state, draw(i))
        if i < n_check:
            record["loss"].append(float(metrics["loss"]))
            record["grad_norm"].append(float(metrics["grad_norm"]))
        if i == 0:
            record["first_grad"] = {
                k: float(torch.linalg.vector_norm(m)) / (1 - opt.b1)
                for k, m in state.opt.mu.items()}
        if i == n_check - 1:
            record["change"] = change_norms(params, layout, cell.seed, dev)
    devtrace.sync()
    cell.mark("warm-up")

    times: List[float] = []
    i, nxt = n_warm, draw(n_warm)
    t_start = time.perf_counter()
    setup_s = t_start - cell.t_process
    while True:
        t0 = time.perf_counter()
        state, _ = step(state, nxt)
        devtrace.sync()
        t1 = time.perf_counter()
        times.append(t1 - t0)
        i += 1
        if t1 - t_start >= cell.seconds:
            break
        nxt = draw(i)
    tokens = int(mix["sequences_per_step"]) * int(mix["seq_len"])
    out = dict(
        e2e=dict(tokens_per_s=len(times) * tokens / (t1 - t_start),
                 setup_s=setup_s),
        steps=len(times), attempted=len(times), failed=0,
        memory_peak_bytes=cell.memory_peak())
    obs = dict(kind="lm_train", arch=cell.config["arch"],
               tokens_per_step=tokens, step_seconds=times,
               flops_per_step=peaks.lm_train_flops(
                   cell.config["arch"], int(mix["sequences_per_step"]),
                   int(mix["seq_len"])))
    if cell.trace:
        def steps():
            nonlocal state, i
            for _ in range(int(mix["trace_steps"])):
                b = draw(i)
                with annotate("repro.train/step"):
                    state, _ = step(state, b)
                devtrace.sync()
                i += 1

        _, sl = devtrace.profiled(steps)
        obs.update(slice=sl, traced_steps=int(mix["trace_steps"]))
        out.update(busy_s=sl.busy_s, window_s=sl.wall_s,
                   breakdown=devtrace.breakdown(sl))
    del state, params, step
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    out.update(obs=obs, check=dict(record=record, layout=layout))
    return out


def follow(cell, layout, precision: str) -> dict:
    """The reference's record of the check's steps, computing in
    ``precision`` from the benchmark's draw of ``layout``. Each weight
    holds what the configuration states: after each update its float32
    result rounded to ``arch["dtype"]``."""
    arch, mix, dev = cell.config["arch"], cell.mix, cell.device
    stored = stated_dtype(arch)
    model = harness.load("reference", cell.config["reference"])
    w = {name: t.float() for name, t in weights(layout, cell.seed, dev)}
    m = {k: torch.zeros_like(t) for k, t in w.items()}
    v = {k: torch.zeros_like(t) for k, t in w.items()}
    rec: dict = dict(loss=[], grad_norm=[])
    for i in range(int(mix["check_steps"])):
        b = batch(cell.seed, i, mix, arch["vocab_size"], dev)
        loss, grads = model.loss_and_grads(arch, w, b["tokens"], b["labels"],
                                           precision)
        norm, clip = adamw.update(w, grads, m, v, i + 1, mix["optimizer"])
        for t in w.values():
            t.copy_(t.to(stored))
        rec["loss"].append(loss)
        rec["grad_norm"].append(norm)
        if i == 0:
            rec["first_grad"] = {k: float(torch.linalg.vector_norm(g)) * clip
                                 for k, g in grads.items()}
        del grads
    del m, v
    rec["change"] = change_norms(w, layout, cell.seed, dev)
    return rec


def compare(got: dict, want: dict) -> Dict[str, float]:
    """The check's numbers of the record ``got`` against ``want``'s."""
    def worst(a: Dict[str, float], b: Dict[str, float], names) -> float:
        med = statistics.median(b[k] for k in names)
        return max(abs(a[k] - b[k]) / max(b[k], med) for k in names)

    first = want["first_grad"]
    floor = LEAF_FLOOR * statistics.median(first.values())
    moving = [k for k, g in first.items() if g >= floor]
    return dict(
        loss_rel=max(abs(x - y) / abs(y)
                     for x, y in zip(got["loss"], want["loss"])),
        grad_norm_rel=max(abs(x - y) / y for x, y in
                          zip(got["grad_norm"], want["grad_norm"])),
        grad_rel=worst(got["first_grad"], first, list(first)),
        update_rel=worst(got["change"], want["change"], moving))


def _reference_record(cell, out) -> dict:
    if "reference" not in out["check"]:
        out["check"]["reference"] = follow(cell, out["check"]["layout"],
                                           "float32")
    return out["check"]["reference"]


def stated_dtype(arch: dict) -> torch.dtype:
    return getattr(torch, arch["dtype"])


def leaves_below(layout, arch: dict) -> int:
    """Leaves of ``layout`` stored in a coarser dtype than the stated."""
    eps = torch.finfo(stated_dtype(arch)).eps
    return sum(torch.finfo(dtype).eps > eps for _, _, dtype in layout)


def numbers(cell, out) -> Dict[str, float]:
    return dict(compare(out["check"]["record"], _reference_record(cell, out)),
                leaves_below_dtype=float(leaves_below(
                    out["check"]["layout"], cell.config["arch"])))


def control(cell, out) -> Dict[str, float]:
    """``numbers`` of the reference one precision below the stated in the
    program's place; it stores the stated dtype, so no leaf is below."""
    low = CONTROL[cell.config["arch"]["dtype"]]
    return dict(compare(follow(cell, out["check"]["layout"], low),
                        _reference_record(cell, out)),
                leaves_below_dtype=0.0)
