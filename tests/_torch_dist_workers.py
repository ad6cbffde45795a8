"""Multi-rank workers for the port's distributed tests, run on CPU ranks
over gloo. They import the port only (never JAX): the tests run the
reference in the parent process and hand its inputs over as numpy.

``spawn(worker, world, tmp_path, payload)`` starts ``world`` processes
(``torch.multiprocessing``, spawn), each joining one process group
through a ``FileStore`` under ``tmp_path`` (no port to collide with
under xdist), runs ``worker(rank, world, payload)`` in every rank and
returns what rank 0 returned; ``Spawned`` does the same without waiting,
so the caller can run the reference meanwhile. A worker's exception
fails the call with its traceback; collectives time out after
``PG_TIMEOUT_S``. With ``gloo=False`` no group is started: the dry-run's
workers make their own fake one (``launch/dryrun.fake_group``).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PG_TIMEOUT_S = 120


def _entry(rank, name, world, store_path, payload_path, out_dir, gloo):
    torch.set_num_threads(1)
    if gloo:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_S))
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        out = globals()[name](rank, world, payload)
        if rank == 0:
            with open(os.path.join(out_dir, "out.pkl"), "wb") as f:
                pickle.dump(out, f)
        if gloo:
            dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class Spawned:
    """``worker(rank, world, payload)`` running on ``world`` gloo ranks;
    ``result()`` waits for them and returns rank 0's result."""

    def __init__(self, worker, world: int, tmp_path, payload,
                 timeout: float = 300.0, gloo: bool = True):
        self.name, self.tmp = worker.__name__, str(tmp_path)
        payload_path = os.path.join(self.tmp, "payload.pkl")
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        self.deadline = time.monotonic() + timeout
        self.ctx = mp.start_processes(
            _entry, args=(self.name, world, os.path.join(self.tmp, "store"),
                          payload_path, self.tmp, gloo),
            nprocs=world, join=False, start_method="spawn")

    def result(self):
        while not self.ctx.join(timeout=1.0):
            if time.monotonic() > self.deadline:
                for p in self.ctx.processes:
                    p.kill()
                raise TimeoutError(f"{self.name} ran past its time limit")
        with open(os.path.join(self.tmp, "out.pkl"), "rb") as f:
            return pickle.load(f)


def spawn(worker, world: int, tmp_path, payload, timeout: float = 300.0,
          gloo: bool = True):
    """``worker(rank, world, payload)`` on ``world`` gloo ranks; rank 0's
    result."""
    return Spawned(worker, world, tmp_path, payload, timeout, gloo).result()


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------

def _full_numpy(tree):
    """{name: numpy} of a module's parameters or a dict of tensors, each
    DTensor gathered (every rank must call)."""
    from torch.distributed.tensor import DTensor
    items = tree.named_parameters() if isinstance(tree, torch.nn.Module) \
        else tree.items()
    out = {}
    for k, v in items:
        v = v.full_tensor() if isinstance(v, DTensor) else v
        out[k] = v.detach().numpy().copy()
    return out


def _state(case, mesh):
    """The reference's train state (numpy) as the port's, on ``mesh``."""
    from repro_torch import interop
    from repro_torch.distributed import sharding as S
    state = interop.train_state_from_numpy(case["params"], case["opt"],
                                           case["cfg"], device="cpu")
    return S.distribute(state, S.param_shardings(state, mesh))


def _batch(case, mesh):
    from repro_torch.distributed import sharding as S
    batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
    return S.distribute(batch, S.batch_shardings(batch, mesh))


def _loss(cfg, mesh, state, batch):
    from repro_torch.train import train_step as TT
    with TT.on_mesh(mesh), torch.no_grad():
        _, m = TT.make_loss_fn(cfg, mesh)(state.params, batch)
    return float(m["loss"].full_tensor())


def _grads(cfg, mesh, state, batch):
    from repro_torch.train import train_step as TT
    named = dict(state.params.named_parameters())
    with TT.on_mesh(mesh):
        total, _ = TT.make_loss_fn(cfg, mesh)(state.params, batch)
        grads = torch.autograd.grad(total, list(named.values()))
    return float(total.full_tensor()), _full_numpy(dict(zip(named, grads)))


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def train_worker(rank, world, payload):
    """For each case (a reduced config, the reference's state and batch):
    the placed state's placements, hooks, remat modes, the MoE forward
    and one sharded train step, on a (2, 2) mesh."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.dryrun import make_hooks
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as TM
    from repro_torch.models import sharding_hooks as hooks
    from repro_torch.train import train_step as TT
    from torch.distributed.tensor import DTensor

    mesh = make_host_mesh(2, 2)
    out = {}
    for arch, case in payload["cases"].items():
        t0 = time.perf_counter()
        cfg = case["cfg"]
        res = out[arch] = {}
        state = _state(case, mesh)
        batch = _batch(case, mesh)
        want = S.param_shardings(state, mesh)
        res["placed"] = all(
            isinstance(p, DTensor) and p.placements == want.params[k]
            .placements and state.opt.mu[k].placements == want.params[k]
            .placements for k, p in state.params.named_parameters())

        b, seq = case["batch"]["tokens"].shape
        hooks.set_hooks(make_hooks(cfg, ShapeSpec("train", seq, b, "train"),
                                   mesh))
        try:
            res["hook_names"] = sorted(hooks.get_hooks())
            res["hooked_loss"] = _loss(cfg, mesh, state, batch)
        finally:
            hooks.set_hooks({})

        if case.get("remat"):
            res["remat"] = {}
            for mode in ("none", "full", "dots"):
                rcfg = dataclasses.replace(cfg, remat=mode)
                res["remat"][mode] = _grads(rcfg, mesh, state, batch)

        if case.get("forward"):
            with TT.on_mesh(mesh), torch.no_grad():
                logits, _, _ = TM.forward(state.params,
                                          {"tokens": batch["tokens"]}, cfg)
            res["logits"] = logits.full_tensor().numpy()

        step = TT.make_train_step(cfg, payload["opt_cfg"], mesh)
        state, metrics = step(state, batch)
        res["metrics"] = {k: float(metrics[k]) for k in
                          ("loss", "aux_loss", "grad_norm")}
        res["metrics_plain"] = not any(
            isinstance(metrics[k], DTensor)
            for k in ("loss", "aux_loss", "grad_norm"))
        res["params"] = _full_numpy(state.params)
        res["still_placed"] = all(
            p.placements == want.params[k].placements
            for k, p in state.params.named_parameters())
        res["seconds"] = time.perf_counter() - t0
    return out


def remesh_worker(rank, world, payload):
    """Save on (2, 2), restore onto (4, 1) and (1, 4); restore the JAX
    package's checkpoint onto (2, 2)."""
    from repro_torch.distributed import sharding as S
    from repro_torch.launch import train as TLT
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import checkpoint as ckpt
    from torch.distributed.tensor import DTensor

    case = payload["case"]
    cfg = case["cfg"]
    mesh_a = make_mesh((2, 2), ("data", "model"), "cpu")
    state = _state(case, mesh_a)
    out = {"loss_a": _loss(cfg, mesh_a, state, _batch(case, mesh_a))}
    ckpt.save(payload["dir_a"], 1, state, metadata={"loss": out["loss_a"]})
    with np.load(os.path.join(payload["dir_a"], "step_00000001",
                              "arrays.npz")) as saved:
        saved = {k: saved[k] for k in saved.files}

    def leaves(tree):
        return [(k, v.full_tensor() if isinstance(v, DTensor) else v)
                for k, v in ckpt._leaves(tree)]

    for shape in ((4, 1), (1, 4)):
        mesh_b = make_mesh(shape, ("data", "model"), "cpu")
        template = TLT._template(cfg)
        restored, step, meta = ckpt.restore(
            payload["dir_a"], template,
            shardings=S.param_shardings(template, mesh_b))
        want = S.param_shardings(restored, mesh_b)
        res = out[shape] = {"step": step, "meta": meta}
        res["placed"] = all(
            p.device_mesh == mesh_b and p.placements == want.params[k]
            .placements for k, p in restored.params.named_parameters())
        res["bit_equal"] = all(
            np.array_equal(np.asarray(v) if not isinstance(v, torch.Tensor)
                           else v.detach().numpy(), saved[k])
            for k, v in leaves(restored))
        res["loss"] = _loss(cfg, mesh_b, restored, _batch(case, mesh_b))

    template = TLT._template(cfg)
    restored, step, _ = ckpt.restore(
        payload["dir_jax"], template,
        shardings=S.param_shardings(template, mesh_a))
    out["from_jax"] = {"step": step,
                       "params": _full_numpy(restored.params),
                       "mu": _full_numpy(restored.opt.mu)}
    return out


def launcher_worker(rank, world, payload):
    """``launch/train.train_loop(mesh=)`` for 2 steps, then again for 3:
    the second run resumes from the first's checkpoint."""
    from repro_torch.launch import train as TLT
    from repro_torch.launch.mesh import make_host_mesh
    from torch.distributed.tensor import DTensor

    mesh = make_host_mesh(2, 2)
    runs, logs = [], []
    for steps in (2, 3):
        run = TLT.RunConfig(steps=steps, ckpt_every=1,
                            ckpt_dir=payload["ckpt_dir"], log_every=1)
        got = TLT.train_loop(payload["cfg"], payload["data_cfg"],
                             payload["opt_cfg"], run, mesh=mesh,
                             log=logs.append)
        runs.append(got["history"])
        placed = all(isinstance(p, DTensor) and p.device_mesh == mesh
                     for p in got["state"].params.parameters())
    return {"histories": runs, "logs": logs, "placed": placed}


def system_worker(rank, world, payload):
    """The train, re-mesh and launcher checks in one process group, and
    each part's seconds."""
    out, seconds = {}, {}
    for name, worker in (("train", train_worker), ("remesh", remesh_worker),
                         ("launcher", launcher_worker)):
        t0 = time.perf_counter()
        out[name] = worker(rank, world, payload[name])
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def comm_worker(rank, world, payload):
    """``compressed_psum`` over a 4-rank group for several steps, and
    ``pipeline_apply`` on (pod 2 x data 2) and (pod 4 x data 1)."""
    from repro_torch.distributed import compression as C
    from repro_torch.distributed import pipeline as PL
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((world,), ("data",), "cpu")
    x = torch.tensor(payload["grads"][rank])
    res = torch.zeros_like(x)
    steps = []
    for _ in range(payload["steps"]):
        q, scale = C.quantize_int8(x + res)
        mean, res = C.compressed_psum(x, mesh, res)
        rows = [torch.empty_like(res) for _ in range(world)]
        dist.all_gather(rows, res)
        qs = [torch.empty_like(q) for _ in range(world)]
        dist.all_gather(qs, q)
        means = [torch.empty_like(mean) for _ in range(world)]
        dist.all_gather(means, mean)
        steps.append({"mean": mean.numpy(),
                      "means_equal": all(torch.equal(m, mean)
                                         for m in means),
                      "res": torch.stack(rows).numpy(),
                      "q": torch.stack(qs).numpy()})
    grads = {f"g{i}": torch.tensor(g) for i, g in
             enumerate(payload["grads"][rank][None])}
    mg, mr = C.compressed_psum_grads(grads, mesh, C.zero_residuals(grads))
    tree = {"dtype_kept": all(mg[k].dtype == grads[k].dtype for k in mg),
            "exact": all(torch.equal(C.dequantize_int8(
                *C.quantize_int8(grads[k])) + mr[k], grads[k]) for k in mg)}

    w = torch.tensor(payload["w"])
    b = torch.tensor(payload["b"])
    x = torch.tensor(payload["x"])

    def layer(lp, h):
        wi, bi = lp
        return torch.tanh(h @ wi + bi)

    pipes = {}
    for shape in ((2, 2), (4, 1)):
        pmesh = make_mesh(shape, ("pod", "data"), "cpu")
        pipes[shape] = PL.pipeline_apply(layer, (w, b), x, mesh=pmesh,
                                         num_micro=payload["num_micro"]
                                         ).numpy()
    seq = x
    for i in range(w.shape[0]):
        seq = layer((w[i], b[i]), seq)
    return {"steps": steps, "tree": tree, "pipes": pipes,
            "sequential": seq.numpy()}


def loss_worker(rank, world, payload):
    """``train_step.cross_entropy`` on a (2, 2) mesh for each case (full
    logits, labels, mask, and whether "model" splits the vocab): the
    loss, the logits' gradient (its placements, local shape and full
    value) and the most elements of any plain tensor an op made on this
    rank in the forward and backward (``LocalShapes``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import train_step as TT

    mesh = make_host_mesh(2, 2)
    out = {}
    for name, case in payload.items():
        vocab = Shard(2) if case["split"] else Replicate()
        sharding = S.Sharding(mesh, (Shard(0), vocab))
        rows = (Shard(0), Replicate())
        logits = S.place(torch.tensor(case["logits"]), sharding)
        logits.requires_grad_()
        labels = S.place(torch.tensor(case["labels"]), S.Sharding(mesh, rows))
        mask = None if case["mask"] is None else S.place(
            torch.tensor(case["mask"]), S.Sharding(mesh, rows))
        with LocalShapes() as shapes:
            loss = TT.cross_entropy(logits, labels, mask, sharding)
            loss.backward()
        grad = logits.grad
        out[name] = {
            "loss": float(loss.full_tensor()),
            "grad": grad.full_tensor().numpy(),
            "grad_placements": tuple(map(str, grad.placements)),
            "grad_local": tuple(grad.to_local().shape),
            "largest": shapes.largest, "is_dtensor": isinstance(grad, DTensor)}
    return out


class LocalShapes(TorchDispatchMode):
    """Records the largest plain tensor (by elements) that an op outputs
    on this rank: DTensor ops are handed on to DTensor, whose local ops
    come back here; the fake and meta tensors of its shape propagation
    are not counted."""

    def __init__(self):
        super().__init__()
        self.largest = (0, ())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t.is_meta \
                    and not isinstance(t, FakeTensor):
                self.largest = max(self.largest, (t.numel(), tuple(t.shape)))
        return out


# ---------------------------------------------------------------------------
# dry-run workers (no gloo group: each makes its own fake one)
# ---------------------------------------------------------------------------

def _cell_summary(r):
    keep = ("status", "reason", "error", "flops", "bytes_accessed",
            "collective_bytes", "collective_counts", "memory", "run_s",
            "flops_corrected", "bytes_corrected",
            "collective_bytes_corrected")
    return {k: r[k] for k in keep if k in r}


def _hook_specs(hooks_dict, mesh):
    """{name: spec (entries per dim) or flag} of a hooks table."""
    from repro_torch.distributed import sharding as S
    out = {}
    for k, v in hooks_dict.items():
        if isinstance(v, S.Sharding):
            ndim = {"residual": 3, "attn_scores_gqa": 5, "attn_scores_mla": 4,
                    "moe_buf": 4, "moe_buf_decode": 3}[k]
            out[k] = tuple(S.to_spec(v.placements, mesh, ndim))
        else:
            out[k] = v
    return out


def dryrun_worker(rank, world, payload):
    """The port's dry-run on fake groups: the reduced configs' cells
    (``payload["archs"]`` x ``["shapes"]``, and ``["vocab_cells"]``'
    (arch, shape, vocab) with the vocab replaced) on ``["multi_pod"]``'s
    production mesh and their ``["corrected"]`` cells; with
    ``["full"]`` (archs) also those full configs' hooks and input specs
    on both meshes, the statuses of ``["status"]``'s cells, per-device
    FLOPs of ``["one_device"]``'s small cells on a (1, 1) mesh and a
    hand-built program's collectives."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_mesh, make_production_mesh

    out = {"cells": {}, "corrected": {}}
    mp = payload.get("multi_pod", False)
    for arch in payload.get("archs", ()):
        cfg = get_config(arch).reduced()
        for shape in payload.get("shapes", ()):
            r = D.run_cell(arch, shape, multi_pod=mp, save=False,
                           cfg_override=cfg, device_type="cpu")
            out["cells"][arch, shape] = _cell_summary(r)
    for arch, shape, vocab in payload.get("vocab_cells", ()):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  vocab_size=vocab)
        r = D.run_cell(arch, shape, multi_pod=mp, save=False,
                       cfg_override=cfg, device_type="cpu")
        out["cells"][arch, shape, vocab] = _cell_summary(r)
    for arch, shape, layers in payload.get("corrected", ()):
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  num_layers=layers)
        r = R.corrected_cell(arch, shape, multi_pod=mp, cfg_override=cfg,
                             device_type="cpu", save=False)
        out["corrected"][arch, shape] = _cell_summary(r)
    if not payload.get("full"):
        return out

    out["hooks"], out["inputs"] = {}, {}
    for multi_pod in (False, True):
        D.fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        for arch in payload["full"]:
            cfg = get_config(arch)
            for s in SHAPES:
                out["hooks"][arch, s.name, multi_pod] = _hook_specs(
                    D.make_hooks(cfg, s, mesh), mesh)
                out["inputs"][arch, s.name] = {
                    k: (tuple(v.shape), str(v.dtype))
                    for k, v in D.input_specs(cfg, s).items()}
                out["inputs"][arch, s.name, "decode"] = {
                    k: (tuple(v.shape), str(v.dtype)) for k, v in
                    D.input_specs(cfg, s, for_decode=True).items()}
    out["status"] = {
        (arch, shape): D.run_cell(arch, shape, multi_pod=False, save=False,
                                  device_type="cpu")
        for arch, shape in payload["status"]}
    out["status"] = {k: {"status": v["status"], "reason": v["reason"]}
                     for k, v in out["status"].items()}

    D.fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    out["one_device"] = {}
    for arch, (name, seq, batch, kind) in payload["one_device"]:
        shape = ShapeSpec(name, seq, batch, kind)
        out["one_device"][arch, kind] = D.count_cell(
            get_config(arch).reduced(), shape, mesh)["flops"]

    D.fake_group(256)
    out["program"] = _collective_program(make_production_mesh(
        device_type="cpu"))
    return out


def _collective_program(mesh):
    """Rank 0's collective bytes and counts of a DTensor program on a
    16 x 16 mesh whose collectives are known: an all-gather over "data"
    of (256, 64) float32 rows, an all-reduce of a (8, 8) partial sum
    over "data", and a reduce-scatter over "model" of a (32, 8) partial
    sum into rows."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from repro_torch.launch.dryrun import LocalCost
    fake = FakeTensorMode()
    with fake:
        x = DTensor.from_local(torch.zeros(16, 64), mesh,
                               (Shard(0), Replicate()), run_check=False)
        y = DTensor.from_local(torch.zeros(8, 8), mesh,
                               (Partial(), Replicate()), run_check=False)
        z = DTensor.from_local(torch.zeros(32, 8), mesh,
                               (Replicate(), Partial()), run_check=False)
        cost = LocalCost(fake)
        with cost:
            x.redistribute(mesh, (Replicate(), Replicate()))
            y.redistribute(mesh, (Replicate(), Replicate()))
            z.redistribute(mesh, (Replicate(), Shard(0)))
    return dict(cost.collective_bytes), dict(cost.collective_counts)
